// Semi-global matching (SGM) kernels, hand-written for Hopper (sm_90a).
//
// Replaces the three Pallas TPU kernels of the census/SGM engine
// (steroscopic_hardware_tpu/ops/sgm.py):
//   sgm_aggregate      <- _aggregate_axis_pallas  (B3)
//   sgm_transpose_add  <- _transpose_add_pallas   (B4)
//   sgm_epilogue       <- _sgm_epilogue_pallas    (B5)
// Each computes what its TPU kernel computes, d-major only, with no pads:
// the kernels mask their ragged edges themselves. Storage types: 0 uint8,
// 1 bfloat16, 2 float32; arithmetic is float32 throughout.
//
// B3, sgm_aggregate. cost (D, S, K) -> out (D, S, K): for each column k the
// SGM recursion along s, forward and backward,
//   L(s, d) = (C(s, d) + best) - m,  m = min_d' L(s-1, d'),
//   best    = min(min(L(s-1, d), min(L(s-1, d+1), L(s-1, d-1)) + P1), m + P2)
// (d outside [0, D) is +INF; L(0) = C), in the operation order of the TPU
// kernel's recurse(), so the fractional-penalty float32 tier matches the
// plain version bit for bit. Each direction is stored in the output type
// and the two are added in it (uint8 widened to int, bfloat16 through
// float32 and rounded), as the TPU kernel's epilogue adds fwd + bwd.
// Two kernels; the launch plan (_kernels.sgm_aggregate_plan) picks one by D.
// Lane-group kernel (D <= 136): a group of G lanes (4 or 8, a power of
// two) owns one scan column; each lane holds DPT contiguous d values of
// both directions in registers and runs the two directions interleaved
// (forward at s = i, backward at s = S - 1 - i: two independent dependency
// chains). min_d' is a min inside the lane and log2(G) xor shuffles; the
// d +- 1 neighbours at a chunk's ends come from __shfl_up/down_sync, +INF
// at the group's ends (the lane-group form of the warp-per-scanline
// mapping of arXiv:1610.04121). Each lane loads and stores its own d
// values in global memory: a warp spans 32 / G adjacent columns, so every
// (d, s) row it touches is 32 / G consecutive elements. No shared memory
// and no block barrier: the lanes of a column meet only in shuffles. The
// cost of both directions is loaded two steps ahead into a ring of
// registers, held in the raw stored type (widened where it is used) with
// 32-bit offsets, so that 17 d values a lane still fit in registers.
// Forward and backward meet in the middle of the column: the first
// direction to reach a row stores its raw path value, the second reads it
// back (also two steps ahead, or from registers where the directions
// cross) and stores the sum; the same thread owns the element at both
// visits, so program order makes the write visible.
// Bound on the H100: memory, D * S * K elements read once and written once
// (e.g. 1080p d64 bf16 -> bf16: 539 MB, 161 us at 3.35 TB/s). This kernel
// reads the cost once per direction and writes and reads back the raw
// half, and in this d-major layout each warp access touches G rows of
// 32 / G columns: G 32-byte sectors where two would hold 32 bf16 values.
// It is bound by those memory transactions, so fewer lanes a column run
// faster as long as the d values fit in registers (1080p d64 on 8 lanes:
// 2.1 ms vertical). Past 8 lanes of 17 (D > 136) it needs 16 lanes, rows
// of 2 columns, and loses (d256: 27 ms against the first port's 8.5).
// Wide kernel (D > 136): a warp per scan column, both directions, 32
// lanes of up to 9 d values; a block of 4 or 8 columns stages each step's
// cost rows through a ring in shared memory several steps ahead and writes
// its rows out from a second ring, the warps meeting at mbarriers only (no
// block barrier per step); see its section below for the layout and bound.
//
// B4, sgm_transpose_add (replaces _transpose_add_pallas,
// steroscopic_hardware_tpu/ops/sgm.py:415). out[d, a, b] = aT[d, b, a]
// (+ bb[d, a, b]) in float32 (the add __fadd_rn(bb, aT)), stored in the
// output type. Bound on the H100: bytes, each input read once and the
// output written once (1080p d64: the cost form u8 -> bf16 404 MB, 121 us
// at 3.35 TB/s; the summed form bf16 + bf16 -> bf16 809 MB, 241 us). The
// first kernel (one 32 x 32 tile of one plane per block, widened to
// float in shared memory) reached 36% / 44% of that: each thread moved
// one or two bytes per memory instruction, so a warp's access held one or
// two 32-byte sectors, and an SM held at most ~8 KB of loads in flight
// where ~18 KB cover the memory latency. This one moves every access in
// 16-byte vectors where the row pitch and the base pointer allow it, else
// 8, 4 or one element (the launch plan picks them; the width divides the
// pitch, so a vector is wholly inside a row or wholly past the tile's
// ragged edge, and the edge is masked per vector). A block walks one tile
// of 128 bytes of a x 64 rows b through a chunk of d planes, staged in
// aT's own type by cp.async up to three planes ahead (8 KB a plane), its
// rows swizzled in 16-byte chunks so that the transposed reads are free
// of bank conflicts; the addend is loaded as vectors before the block
// waits for the tile, and each thread writes 8 values of b (16 bytes of
// bfloat16) per row. At 24-48 registers 8 blocks of 256 threads fit an
// SM, so 2 planes a block already keep ~128 KB in flight per SM. There is
// no TMA: a tensor map needs row strides of a multiple of 16 bytes, and
// the 1080-byte uint8 rows of the served cost volume are not (they take
// 8-byte accesses).
//
// B5, sgm_epilogue (replaces _sgm_epilogue_pallas,
// steroscopic_hardware_tpu/ops/sgm.py:550). agg_v (D, H, W) + agg_ht
// (D, W, H) -> disparity float32 (H, W): c(d) = agg_v[d] + agg_ht[d]^T in
// float32, a running first-minimum argmin over increasing d (strict <),
// the neighbour costs captured in the sweep (a win takes the previous
// slice as c0; the slice after the winner gives c2), then the parabola
//   denom = max(c0 - 2 best + c2, 1e-6), delta = clip(0.5 (c0 - c2) / denom)
// for 1 <= d <= D - 2, with each operation rounded as torch rounds it
// (explicit _rn intrinsics: no FMA contraction). The summed volume never
// reaches memory. Bound on the H100: bytes, both volumes read once and the
// map written once (1080p d64 uint8: 273 MB, 83 us at 3.35 TB/s). The
// first kernel (a 32 x 32 tile a block, one-element loads, one plane in
// flight behind two block barriers a plane) reached 16% of it. This one
// gives each block a 64 x 64 pixel tile, stages both volumes' tiles of
// each plane by cp.async in 16-byte vectors where the row pitch and base
// pointer allow it, else 8, 4 or one element (the launch plan picks them:
// 8 bytes on the 1080-byte uint8 rows of agg_ht), into a ring of 3 or 4
// slots in B4's swizzled layout, so several planes are in flight, behind
// one block barrier a plane. The argmin runs over all d, so the d range is
// not split: a thread keeps its 16 pixels' running state in registers for
// the whole sweep (splitting d over warps would multiply that state by the
// chunks and bring no more bytes in flight than the ring does). uint8
// sums in int: no conversion in the d loop.
//
// C interface (bound with ctypes): device pointers, sizes, type codes and
// the CUDA stream; each launches on that stream on the current device
// without synchronising and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float INF = 1e9f;  // the TPU kernels' +INF: never wins a min
constexpr unsigned FULL = 0xffffffffu;
enum { T_U8 = 0, T_BF16 = 1, T_F32 = 2 };

__device__ __forceinline__ float widen(uint8_t x) { return static_cast<float>(x); }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float widen(float x) { return x; }

// float32 -> storage type: uint8 through int, truncating (the values are
// small exact integers under the uint8 tier), bfloat16 round-to-nearest.
template <typename T> __device__ __forceinline__ T narrow(float x);
template <> __device__ __forceinline__ uint8_t narrow<uint8_t>(float x) {
  return static_cast<uint8_t>(static_cast<int>(x));
}
template <> __device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <> __device__ __forceinline__ float narrow<float>(float x) { return x; }

// a + b of two stored values, in the storage type
__device__ __forceinline__ uint8_t add_stored(uint8_t a, uint8_t b) {
  return static_cast<uint8_t>(static_cast<int>(a) + static_cast<int>(b));
}
__device__ __forceinline__ __nv_bfloat16 add_stored(__nv_bfloat16 a, __nv_bfloat16 b) {
  return __float2bfloat16_rn(__fadd_rn(__bfloat162float(a), __bfloat162float(b)));
}
__device__ __forceinline__ float add_stored(float a, float b) { return __fadd_rn(a, b); }

// -- B3 ------------------------------------------------------------------------

// The largest D either kernel takes: the wide kernel's 32 lanes of 9 d
// values. The lane-group kernel is compiled for 5, 9 and 17 d values a
// lane and blocks of up to AGG_BLOCK_MAX threads.
constexpr int AGG_DMAX = 288;
constexpr int AGG_BLOCK_MAX = 256;

// Lane-group kernel. One thread: the d values d0 .. d0 + DPT - 1 of one
// scan column, in both directions (forward at s = i, backward at
// s = S - 1 - i: two independent chains); the other G - 1 lanes of its
// group hold the column's other chunks. Ring slot Q of cf / cb holds the
// cost of the steps i with i % 2 == Q, loaded two steps ahead; slot Q of
// xf / xb the raw partials (the other direction's stored value) those
// steps add to.
template <typename Tin, typename Tout, int DPT>
struct AggLane {
  const Tin* cost;
  Tout* out;
  uint32_t base, SK, K;  // element offsets (the volume has < 2^32 elements):
                         // base is (d0, 0, k)
  int S, g, G, nv;       // nv: valid d values of this lane (0 past K)
  float p1, p2;
  float Lf[DPT], Lb[DPT];
  Tin cf[2][DPT], cb[2][DPT];  // raw: widened where used, so that no
  Tout xf[2][DPT], xb[2][DPT];  // instruction waits on a load in flight

  __device__ __forceinline__ void load_cost(Tin (&c)[DPT], int s) const {
    const uint32_t o = base + static_cast<uint32_t>(s) * K;
#pragma unroll
    for (int j = 0; j < DPT; ++j)
      if (j < nv) c[j] = cost[o + j * SK];
  }

  __device__ __forceinline__ void load_raw(Tout (&x)[DPT], int s) const {
    const uint32_t o = base + static_cast<uint32_t>(s) * K;
#pragma unroll
    for (int j = 0; j < DPT; ++j)
      if (j < nv) x[j] = out[o + j * SK];
  }

  // L(s - 1) -> L(s) from the cost row c of s, in the TPU kernel's order
  __device__ __forceinline__ void recurse(float (&L)[DPT], const Tin (&c)[DPT]) const {
    float m = L[0];
#pragma unroll
    for (int j = 1; j < DPT; ++j) m = fminf(m, L[j]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      if (o < G) m = fminf(m, __shfl_xor_sync(FULL, m, o));
    float up_edge = __shfl_down_sync(FULL, L[0], 1);  // d = d0 + DPT
    float dn = __shfl_up_sync(FULL, L[DPT - 1], 1);   // d = d0 - 1
    if (g == G - 1) up_edge = INF;
    if (g == 0) dn = INF;
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      const float up = j + 1 < DPT ? L[j + 1 < DPT ? j + 1 : j] : up_edge;
      const float best =
          fminf(fminf(L[j], __fadd_rn(fminf(up, dn), p1)), __fadd_rn(m, p2));
      dn = L[j];
      L[j] = j < nv ? __fsub_rn(__fadd_rn(widen(c[j]), best), m) : INF;
    }
  }

  template <int Q>
  __device__ __forceinline__ void step(int i) {
    const int sf = i, sb = S - 1 - i;
    if (Q == 0 && i == 0) {
#pragma unroll
      for (int j = 0; j < DPT; ++j) {
        Lf[j] = j < nv ? widen(cf[Q][j]) : INF;
        Lb[j] = j < nv ? widen(cb[Q][j]) : INF;
      }
    } else {
      recurse(Lf, cf[Q]);
      recurse(Lb, cb[Q]);
    }
    if (i + 2 < S) {  // the cost two steps ahead, into the slot just used
      load_cost(cf[Q], sf + 2);
      load_cost(cb[Q], sb - 2);
    }
    // store: raw where the other direction has not been yet, the sum where
    // it has (or is, in the middle row of an odd S)
    const uint32_t of = base + static_cast<uint32_t>(sf) * K;
    const uint32_t ob = base + static_cast<uint32_t>(sb) * K;
    if (sf < sb) {
#pragma unroll
      for (int j = 0; j < DPT; ++j)
        if (j < nv) {
          out[of + j * SK] = narrow<Tout>(Lf[j]);
          out[ob + j * SK] = narrow<Tout>(Lb[j]);
        }
      if (sf + 1 == sb) {  // the directions cross before step i + 1
#pragma unroll
        for (int j = 0; j < DPT; ++j) {
          xf[1 - Q][j] = narrow<Tout>(Lb[j]);
          xb[1 - Q][j] = narrow<Tout>(Lf[j]);
        }
      }
    } else if (sf == sb) {
#pragma unroll
      for (int j = 0; j < DPT; ++j)
        if (j < nv) out[of + j * SK] = add_stored(narrow<Tout>(Lf[j]), narrow<Tout>(Lb[j]));
    } else {
#pragma unroll
      for (int j = 0; j < DPT; ++j)
        if (j < nv) {
          out[of + j * SK] = add_stored(xf[Q][j], narrow<Tout>(Lf[j]));
          out[ob + j * SK] = add_stored(xb[Q][j], narrow<Tout>(Lb[j]));
        }
    }
    // the raw partials of step t = i + 2, once this thread has stored
    // both (at step S - 1 - t <= i; program order makes them visible)
    if (i + 2 < S && 2 * (i + 2) > S) {
      load_raw(xf[Q], sf + 2);
      load_raw(xb[Q], sb - 2);
    }
  }
};

template <typename Tin, typename Tout, int DPT>
__global__ void __launch_bounds__(AGG_BLOCK_MAX)
    sgm_aggregate_lanes_kernel(const Tin* __restrict__ cost, Tout* __restrict__ out,
                               int D, int S, int K, int G, float p1, float p2) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int k = t / G;
  AggLane<Tin, Tout, DPT> a;
  a.cost = cost;
  a.out = out;
  a.S = S;
  a.K = K;
  a.G = G;
  a.g = t % G;
  a.p1 = p1;
  a.p2 = p2;
  a.SK = static_cast<uint32_t>(S) * static_cast<uint32_t>(K);
  const int d0 = a.g * DPT;
  a.nv = k < K ? max(0, min(DPT, D - d0)) : 0;
  a.base = static_cast<uint32_t>(d0) * a.SK + min(k, K - 1);
#pragma unroll
  for (int j = 0; j < DPT; ++j) {
    a.cf[0][j] = a.cb[0][j] = a.cf[1][j] = a.cb[1][j] = Tin();
    a.xf[0][j] = a.xb[0][j] = a.xf[1][j] = a.xb[1][j] = narrow<Tout>(0.f);
  }
  a.load_cost(a.cf[0], 0);
  a.load_cost(a.cb[0], S - 1);
  if (S > 1) {
    a.load_cost(a.cf[1], 1);
    a.load_cost(a.cb[1], S - 2);
  }
  for (int i = 0; i < S; i += 2) {
    a.template step<0>(i);
    if (i + 1 < S) a.template step<1>(i + 1);
  }
}

// Wide-disparity kernel (D > 136; it takes any D <= 32 * VPL). A block owns
// TK = 4, 8 or 16 adjacent scan columns, one warp per column (32 * TK
// threads), and each warp runs its column's forward and backward chains
// interleaved (two independent chains a warp), lane l holding d = l * VPL
// .. + VPL - 1 of both (VPL 5, 7 or 9). Every thread is also a loader and
// a storer of its share of the block's rows, so no warp is specialised;
// warps meet only at mbarriers, one arrival a warp, never at a block
// barrier:
//  - the cost ring (ring slots): the slot of step i holds the block's cost
//    rows of s = i (forward) and s = S - 1 - i (backward). Each thread
//    copies its 4-byte pieces (element copies where the row pitch or base
//    pointer is not a multiple of 4 bytes) by cp.async ring - 2 steps
//    ahead, one group a step, and its warp arrives on full[slot] once the
//    group holding the step has landed, the newer ones still in flight;
//    empty[slot] completes when every warp has read it.
//  - the out ring (WIDE_OUT_RING slots): each warp writes its column's
//    path values there in the stored type; one step later (WIDE_LAG) the
//    threads write the block's rows out in pieces of up to 16 bytes
//    (ofull / oempty), adding the raw halves on a row's second visit.
//  - the raw ring (WIDE_RAW_RING slots): a row's raw half, stored on its
//    first visit, is read back by the thread that stored it (the same
//    piece) by cp.async, a step or two ahead, or, one step after the
//    crossing, copied there from the values being stored.
// Shared memory keeps a row's 4-byte units apart: unit u of row d at word
// u * (32 VPL + 32 / units) + d. A warp's 32 lanes read d values VPL (odd)
// words apart, 32 different banks, so the per-lane reads of one column are
// free of conflicts although a row holds TK columns, and the pad spreads
// the units of the 32 / units rows one warp copies over the 32 banks.
// min_d' L is one redux.sync min over the warp on order-preserving uint32
// keys of the floats (min is exact, so the result is fminf's bit for bit);
// the d +- 1 neighbours at a lane's ends are two shuffles.
// Blocks are paced: a block starts step i only once every block has
// finished step i - WIDE_PACE_LEAD (counters in global memory, zeroed by
// the caller; only when the whole grid is resident). Unpaced, blocks on
// SMs with more blocks fall behind, the blocks stop sharing the DRAM pages
// and L2 lines of each step's rows, and a step took 2-3x as long.
// Bound on the H100: memory, D * S * K elements read once and written once
// (1080p d256 vertical bf16 -> bf16: 2.13 GB, 0.636 ms at 3.35 TB/s). The
// kernel reads the cost once per direction and writes and reads back the
// raw halves, 2.5x those bytes, and its rows of TK columns fill 4 to 64
// bytes: a step of an SM is paced by its memory instructions (their
// count, whatever their width, and one L1 wavefront per row a warp
// instruction touches) and its issue (~11 float operations per d value
// and direction), so wider rows and pieces move more columns a step, and
// the plan takes the most columns whose shared memory fits and whose grid
// still fills half the SMs.
constexpr int WIDE_OUT_RING = 3;  // out ring slots
constexpr int WIDE_RAW_RING = 3;  // raw-half slots
constexpr int WIDE_LAG = 1;       // step i's rows are written out at iteration i + WIDE_LAG
constexpr int WIDE_RING_MIN = 3, WIDE_RING_MAX = 6;
constexpr int WIDE_THREADS = 512;  // the largest block: 16 columns
// pacing: a block starts step i only once every block has finished step
// i - WIDE_PACE_LEAD; block counts per step in a ring of WIDE_PACE_SLOTS
// counters (> WIDE_PACE_LEAD, so a slot is reused only once all blocks
// are past its previous step)
constexpr int WIDE_PACE_LEAD = 4, WIDE_PACE_SLOTS = 8;

struct WideGeom {  // the shared-memory carve-up of one block, bytes
  int uin, uout;   // 4-byte units of a row's TK columns: cost, out
  int rin, rout;   // words from one unit's region to the next: 32 * VPL rows
                   // d and a pad of 32 / units, so that the units of the
                   // 32 / units rows one warp copies fall in 32 banks
  int cost, outs, raw, bars, total;
};

__host__ __device__ inline WideGeom wide_geom(int vpl, int tk, int ein, int eout, int ring) {
  WideGeom g;
  g.uin = tk * ein / 4;
  g.uout = tk * eout / 4;
  g.rin = 32 * vpl + (g.uin > 1 ? 32 / g.uin : 0);
  g.rout = 32 * vpl + (g.uout > 1 ? 32 / g.uout : 0);
  g.cost = 2 * g.uin * g.rin * 4;  // a slot: both directions
  g.outs = 2 * g.uout * g.rout * 4;
  g.raw = 2 * 32 * vpl * tk * eout;  // a slot: both directions' rows, packed
  g.bars = 16 * ((8 * (2 * ring + 2 * WIDE_OUT_RING) + 15) / 16);
  g.total = g.bars + ring * g.cost + WIDE_OUT_RING * g.outs + WIDE_RAW_RING * g.raw;
  return g;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void bar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// one arrival for the warp, after all its lanes' earlier accesses (the
// __syncwarp orders them before lane 0's release): a warp's 32 arrivals
// on one mbarrier would be 32 shared-memory atomics to one word
__device__ __forceinline__ void warp_arrive(uint32_t bar) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) bar_arrive(bar);
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// waits for this thread's cp.async groups but the newest n (0 .. 3)
__device__ __forceinline__ void cp_async_wait_newer(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    default: cp_async_wait<3>(); break;
  }
}

// a cp.async of W = 4, 8 or 16 bytes; the clobber keeps it after this
// thread's earlier stores (a raw half is read back from where this thread
// stored it)
template <int W>
__device__ __forceinline__ void copy_async(void* dst, const void* src) {
  if constexpr (W == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(smem_addr(dst)), "l"(src),
                 "n"(W)
                 : "memory");
}

// add_stored on each value of two 4-byte words of stored values
template <typename T> __device__ __forceinline__ uint32_t add_words(uint32_t a, uint32_t b);
template <> __device__ __forceinline__ uint32_t add_words<uint8_t>(uint32_t a, uint32_t b) {
  return __vadd4(a, b);  // four uint8 adds, each modulo 256
}
template <> __device__ __forceinline__ uint32_t add_words<__nv_bfloat16>(uint32_t a, uint32_t b) {
  const uint32_t lo = __bfloat16_as_ushort(add_stored(
      __ushort_as_bfloat16(static_cast<unsigned short>(a)),
      __ushort_as_bfloat16(static_cast<unsigned short>(b))));
  const uint32_t hi = __bfloat16_as_ushort(add_stored(
      __ushort_as_bfloat16(static_cast<unsigned short>(a >> 16)),
      __ushort_as_bfloat16(static_cast<unsigned short>(b >> 16))));
  return lo | (hi << 16);
}
template <> __device__ __forceinline__ uint32_t add_words<float>(uint32_t a, uint32_t b) {
  return __float_as_uint(__fadd_rn(__uint_as_float(a), __uint_as_float(b)));
}
// a counter other blocks update, read from L2
__device__ __forceinline__ int load_relaxed(const int* p) {
  int v;
  asm volatile("ld.relaxed.gpu.global.s32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}
// waits until the phase of the given parity has completed
__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// min of a float over the warp: redux.sync on keys that order as the
// floats do (non-negative floats: the sign bit set; negative: inverted)
__device__ __forceinline__ float warp_min(float m) {
  const uint32_t u = __float_as_uint(m);
  const uint32_t k = __reduce_min_sync(FULL, u ^ ((u >> 31) ? 0xffffffffu : 0x80000000u));
  return __uint_as_float(k ^ ((k >> 31) ? 0x80000000u : 0xffffffffu));
}

// L(s - 1) -> L(s) for one lane's VPL d values (nv of them valid), in the
// TPU kernel's order (as AggLane::recurse over the whole warp)
template <int VPL, typename T>
__device__ __forceinline__ void wide_recurse(float (&L)[VPL], const T (&c)[VPL], int lane,
                                             int nv, float p1, float p2) {
  float m = L[0];
#pragma unroll
  for (int j = 1; j < VPL; ++j) m = fminf(m, L[j]);
  m = warp_min(m);
  float up_edge = __shfl_down_sync(FULL, L[0], 1);  // d = d0 + VPL
  float dn = __shfl_up_sync(FULL, L[VPL - 1], 1);   // d = d0 - 1
  if (lane == 31) up_edge = INF;
  if (lane == 0) dn = INF;
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    const float up = j + 1 < VPL ? L[j + 1 < VPL ? j + 1 : j] : up_edge;
    const float best =
        fminf(fminf(L[j], __fadd_rn(fminf(up, dn), p1)), __fadd_rn(m, p2));
    dn = L[j];
    L[j] = j < nv ? __fsub_rn(__fadd_rn(widen(c[j]), best), m) : INF;
  }
}

// a slot index and the parity of its phase, advanced one step at a time
struct RingPos {
  int q, ph;
  __device__ __forceinline__ void next(int n) {
    if (++q == n) {
      q = 0;
      ph ^= 1;
    }
  }
};

template <typename Tin, typename Tout, int VPL>
__global__ void __launch_bounds__(WIDE_THREADS, 1)
    sgm_aggregate_wide_kernel(const Tin* __restrict__ cost, Tout* __restrict__ out, int D,
                              int S, int K, int ring, int wc, int wo, float p1, float p2,
                              int* __restrict__ pace) {
  constexpr int EI = sizeof(Tin), EO = sizeof(Tout);
  constexpr int NO = WIDE_OUT_RING, NR = WIDE_RAW_RING, LAG = WIDE_LAG;
  extern __shared__ __align__(16) unsigned char smem[];
  const int NT = blockDim.x, tk = NT >> 5;
  const int tid = threadIdx.x, lane = tid & 31, col = tid >> 5;
  const int pd = ring - 2;      // steps the cost is loaded ahead
  const int pr = NR - 1 - LAG;  // iterations the raw halves are loaded ahead
  const WideGeom g = wide_geom(VPL, tk, EI, EO, ring);
  const uint32_t full0 = smem_addr(smem), empty0 = full0 + 8 * ring;
  const uint32_t ofull0 = empty0 + 8 * ring, oempty0 = ofull0 + 8 * NO;
  unsigned char* const ring0 = smem + g.bars;
  unsigned char* const oring0 = ring0 + ring * g.cost;
  unsigned char* const raw0 = oring0 + NO * g.outs;
  const bool cost_async = wc == 4, raw_async = wo >= 4;
  if (tid == 0) {  // every barrier takes one arrival a warp
    for (int q = 0; q < ring; ++q) {
      bar_init(full0 + 8 * q, tk);
      bar_init(empty0 + 8 * q, tk);
    }
    for (int q = 0; q < NO; ++q) {
      bar_init(ofull0 + 8 * q, tk);
      bar_init(oempty0 + 8 * q, tk);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();  // once, before the scan: the barriers exist

  // the block's columns k0 .. k0 + tk - 1; byte pitches of a row (s) and a
  // plane (d); pieces: a row's tk columns cut in wc-byte (cost) or wo-byte
  // (out) pieces, piece p of a direction is row d = p / ppr, byte x
  const int k0 = blockIdx.x * tk;
  const size_t pin = static_cast<size_t>(K) * EI, pout = static_cast<size_t>(K) * EO;
  const size_t plane_in = pin * S, plane_out = pout * S;
  const unsigned char* const cb = reinterpret_cast<const unsigned char*>(cost);
  unsigned char* const ob = reinterpret_cast<unsigned char*>(out);
  const int lim_in = min(tk, K - k0) * EI, lim_out = min(tk, K - k0) * EO;
  const int ppr_c = tk * EI / wc, lg_c = __ffs(ppr_c) - 1, pc = D * ppr_c;
  const int ppr_o = tk * EO / wo, lg_o = __ffs(ppr_o) - 1, po = D * ppr_o;
  const int dir_in = g.uin * g.rin * 4, dir_out = g.uout * g.rout * 4;  // bwd half of a slot
  const int raw_dir = D * tk * EO;  // bwd half of a raw slot: piece p at p * wo

  // step e revisits its rows (the other direction was there at step
  // S - 1 - e) when e > S - 1 - e; from two steps past the crossing its raw
  // halves come back from memory, loaded by the thread that stored them at
  // iteration rawit(e): pr iterations before they are stored, or the first
  // iteration after the other direction's store
  auto far = [&](int e) { return 2 * e - S + 1 >= 2; };
  auto rawit = [&](int e) { return max(e + LAG - pr, S - e + LAG); };

  auto issue_cost = [&](int c, RingPos pos) {
    if (c >= ring) bar_wait(empty0 + 8 * pos.q, pos.ph ^ 1);
    unsigned char* const slot = ring0 + pos.q * g.cost;
    const size_t rf = static_cast<size_t>(c) * pin + static_cast<size_t>(k0) * EI;
    const size_t rb = static_cast<size_t>(S - 1 - c) * pin + static_cast<size_t>(k0) * EI;
    for (int p = tid; p < pc; p += NT) {
      const int d = p >> lg_c, x = (p & (ppr_c - 1)) * wc;
      if (x >= lim_in) continue;
      const unsigned char* src = cb + static_cast<size_t>(d) * plane_in + x;
      unsigned char* dst = slot + ((x >> 2) * g.rin + d) * 4 + (x & 3);
      if (cost_async) {
        copy_async<4>(dst, src + rf);
        copy_async<4>(dst + dir_in, src + rb);
      } else {
        *reinterpret_cast<Tin*>(dst) = *reinterpret_cast<const Tin*>(src + rf);
        *reinterpret_cast<Tin*>(dst + dir_in) = *reinterpret_cast<const Tin*>(src + rb);
      }
    }
  };

  // the raw halves of step e: rows e (forward) and S - 1 - e (backward),
  // stored at step S - 1 - e by this same thread (the same pieces), into
  // raw slot e % NR, piece p of a direction at p * wo
  auto issue_raw = [&](int e) {
    unsigned char* const slot = raw0 + (e % NR) * g.raw;
    const size_t rf = static_cast<size_t>(e) * pout + static_cast<size_t>(k0) * EO;
    const size_t rb = static_cast<size_t>(S - 1 - e) * pout + static_cast<size_t>(k0) * EO;
    for (int p = tid; p < po; p += NT) {
      const int d = p >> lg_o, x = (p & (ppr_o - 1)) * wo;
      if (x >= lim_out) continue;
      const unsigned char* src = ob + static_cast<size_t>(d) * plane_out + x;
      unsigned char* dst = slot + p * wo;
      if (wo == 16) {
        copy_async<16>(dst, src + rf);
        copy_async<16>(dst + raw_dir, src + rb);
      } else if (wo == 8) {
        copy_async<8>(dst, src + rf);
        copy_async<8>(dst + raw_dir, src + rb);
      } else if (wo == 4) {
        copy_async<4>(dst, src + rf);
        copy_async<4>(dst + raw_dir, src + rb);
      } else {
        for (int w = 0; w < wo; w += EO) {
          *reinterpret_cast<Tout*>(dst + w) = *reinterpret_cast<const Tout*>(src + w + rf);
          *reinterpret_cast<Tout*>(dst + raw_dir + w) =
              *reinterpret_cast<const Tout*>(src + w + rb);
        }
      }
    }
  };

  // step e's rows out (at iteration i = e + LAG): the forward row e and the
  // backward row S - 1 - e, their values or, on the second visit, their
  // sums with the raw halves; one row, the sum, in the middle of an odd S.
  // Just before the crossing (e + 1 == S - 1 - e) the values are also the
  // next step's raw halves, swapped, and go to its raw slot directly.
  auto store_step = [&](int e, int i) {
    const int q = e % NO, sb = S - 1 - e;
    bar_wait(ofull0 + 8 * q, (e / NO) & 1);
    if (pace != nullptr && tid == 0)  // every warp of the block is past step e
      atomicAdd(pace + e % WIDE_PACE_SLOTS, 1);
    // the raw halves' group has landed (the groups committed after it, up
    // to the last loader iteration, may stay in flight)
    if (far(e) && raw_async) cp_async_wait_newer(min(i, S - 1) - rawit(e));
    const unsigned char* const slot = oring0 + q * g.outs;
    const unsigned char* const rs = raw0 + (e % NR) * g.raw;
    unsigned char* const next = raw0 + ((e + 1) % NR) * g.raw;
    const bool cross = e + 1 == sb;
    const size_t rf = static_cast<size_t>(e) * pout + static_cast<size_t>(k0) * EO;
    const size_t rb = static_cast<size_t>(sb) * pout + static_cast<size_t>(k0) * EO;
    for (int p = tid; p < po; p += NT) {
      const int d = p >> lg_o, x = (p & (ppr_o - 1)) * wo;
      if (x >= lim_out) continue;
      unsigned char* const row = ob + static_cast<size_t>(d) * plane_out + x;
      const unsigned char* const src = slot + ((x >> 2) * g.rout + d) * 4 + (x & 3);
      if (wo >= 4) {
        const int n = wo >> 2;
        uint32_t f[4] = {0, 0, 0, 0}, b[4] = {0, 0, 0, 0};
#pragma unroll
        for (int w = 0; w < 4; ++w)
          if (w < n) {
            f[w] = *reinterpret_cast<const uint32_t*>(src + w * g.rout * 4);
            b[w] = *reinterpret_cast<const uint32_t*>(src + dir_out + w * g.rout * 4);
          }
        if (e > sb) {  // the second visit: add the raw halves
          const uint32_t* rhf = reinterpret_cast<const uint32_t*>(rs + p * wo);
          const uint32_t* rhb = reinterpret_cast<const uint32_t*>(rs + raw_dir + p * wo);
#pragma unroll
          for (int w = 0; w < 4; ++w)
            if (w < n) {
              f[w] = add_words<Tout>(rhf[w], f[w]);
              b[w] = add_words<Tout>(rhb[w], b[w]);
            }
        } else if (e == sb) {
#pragma unroll
          for (int w = 0; w < 4; ++w)
            if (w < n) f[w] = add_words<Tout>(f[w], b[w]);
        } else if (cross) {
#pragma unroll
          for (int w = 0; w < 4; ++w)
            if (w < n) {
              reinterpret_cast<uint32_t*>(next + p * wo)[w] = b[w];
              reinterpret_cast<uint32_t*>(next + raw_dir + p * wo)[w] = f[w];
            }
        }
        if (n == 4) {
          *reinterpret_cast<uint4*>(row + rf) = make_uint4(f[0], f[1], f[2], f[3]);
          if (e != sb) *reinterpret_cast<uint4*>(row + rb) = make_uint4(b[0], b[1], b[2], b[3]);
        } else if (n == 2) {
          *reinterpret_cast<uint2*>(row + rf) = make_uint2(f[0], f[1]);
          if (e != sb) *reinterpret_cast<uint2*>(row + rb) = make_uint2(b[0], b[1]);
        } else {
          *reinterpret_cast<uint32_t*>(row + rf) = f[0];
          if (e != sb) *reinterpret_cast<uint32_t*>(row + rb) = b[0];
        }
      } else {
        for (int w = 0; w < wo; w += EO) {
          const int at = (((x + w) >> 2) - (x >> 2)) * g.rout * 4 + ((x + w) & 3) - (x & 3);
          Tout f = *reinterpret_cast<const Tout*>(src + at);
          Tout b = *reinterpret_cast<const Tout*>(src + dir_out + at);
          if (e > sb) {
            f = add_stored(*reinterpret_cast<const Tout*>(rs + p * wo + w), f);
            b = add_stored(*reinterpret_cast<const Tout*>(rs + raw_dir + p * wo + w), b);
          } else if (e == sb) {
            f = add_stored(f, b);
          } else if (cross) {
            *reinterpret_cast<Tout*>(next + p * wo + w) = b;
            *reinterpret_cast<Tout*>(next + raw_dir + p * wo + w) = f;
          }
          *reinterpret_cast<Tout*>(row + rf + w) = f;
          if (e != sb) *reinterpret_cast<Tout*>(row + rb + w) = b;
        }
      }
    }
    warp_arrive(oempty0 + 8 * q);
  };

  // loader work of iteration i (i < 0: the prologue): the cost of step
  // i + pd and the raw halves whose load falls on i (see rawit), one
  // cp.async group; then the full arrival of step i + 1, once the group
  // holding its cost has landed (the pd - 1 newer groups stay in flight)
  RingPos lpos{0, 0};              // slot of step c = i + pd
  int qn = (ring + 1 - pd) % ring;  // slot of step n = i + 1
  int paced = 0;  // thread 0: step i - WIDE_PACE_LEAD's count, read an iteration ago
  auto loader = [&](int i) {
    const int c = i + pd, n = i + 1;
    if (pace != nullptr && tid == 0) {
      const int j = i - WIDE_PACE_LEAD;
      if (j >= 0) {
        const int want = (j / WIDE_PACE_SLOTS + 1) * static_cast<int>(gridDim.x);
        while (paced < want) paced = load_relaxed(pace + j % WIDE_PACE_SLOTS);
      }
      if (j + 1 >= 0 && j + 1 < S) paced = load_relaxed(pace + (j + 1) % WIDE_PACE_SLOTS);
    }
    if (c < S) issue_cost(c, lpos);
    const int e1 = i - LAG + pr, e2 = S + LAG - i;
    if (e1 >= 0 && e1 < S && far(e1) && rawit(e1) == i) issue_raw(e1);
    if (e2 < S && e2 != e1 && far(e2) && rawit(e2) == i) issue_raw(e2);
    cp_async_commit();
    if (c < S) lpos.next(ring);
    if (n >= 0 && n < S) {
      cp_async_wait_newer(i - (n - pd));
      warp_arrive(full0 + 8 * qn);
    }
    qn = qn + 1 == ring ? 0 : qn + 1;
  };

  // this lane's d values in the consumer's view of a slot
  const int nv = max(0, min(VPL, D - lane * VPL));
  const int at_in = ((col * EI) >> 2) * g.rin * 4 + ((col * EI) & 3) + lane * VPL * 4;
  const int at_out = ((col * EO) >> 2) * g.rout * 4 + ((col * EO) & 3) + lane * VPL * 4;
  float Lf[VPL], Lb[VPL];
  RingPos cpos{0, 0};
  auto consume = [&](int i) {
    bar_wait(full0 + 8 * cpos.q, cpos.ph);
    const unsigned char* cs = ring0 + cpos.q * g.cost + at_in;
    Tin cf[VPL], cbk[VPL];
#pragma unroll
    for (int j = 0; j < VPL; ++j) {
      cf[j] = *reinterpret_cast<const Tin*>(cs + 4 * j);
      cbk[j] = *reinterpret_cast<const Tin*>(cs + dir_in + 4 * j);
    }
    warp_arrive(empty0 + 8 * cpos.q);
    cpos.next(ring);
    if (i == 0) {
#pragma unroll
      for (int j = 0; j < VPL; ++j) {
        Lf[j] = j < nv ? widen(cf[j]) : INF;
        Lb[j] = j < nv ? widen(cbk[j]) : INF;
      }
    } else {
      wide_recurse(Lf, cf, lane, nv, p1, p2);
      wide_recurse(Lb, cbk, lane, nv, p1, p2);
    }
    const int oq = i % NO;
    if (i >= NO) bar_wait(oempty0 + 8 * oq, ((i / NO) - 1) & 1);
    unsigned char* const os = oring0 + oq * g.outs + at_out;
#pragma unroll
    for (int j = 0; j < VPL; ++j) {
      *reinterpret_cast<Tout*>(os + 4 * j) = narrow<Tout>(Lf[j]);
      *reinterpret_cast<Tout*>(os + dir_out + 4 * j) = narrow<Tout>(Lb[j]);
    }
    warp_arrive(ofull0 + 8 * oq);
  };

  for (int i = -pd; i < 0; ++i) loader(i);
  for (int i = 0; i < S; ++i) {
    loader(i);
    consume(i);
    if (i >= LAG) store_step(i - LAG, i);
  }
  for (int i = max(S, LAG); i < S + LAG; ++i) store_step(i - LAG, i);
}

// A launch plan (see sgm_aggregate below); checked before it is launched.
struct AggPlan {
  int wide, G, dpt, block, grid, ring;
};

// pace: WIDE_PACE_SLOTS zeroed counters, or null for no pacing; pacing is
// used only when the whole grid is resident at once (a block waits for
// every other block)
template <typename Tin, typename Tout, int VPL>
cudaError_t launch_wide(const AggPlan& p, const Tin* cost, Tout* out, int D, int S, int K,
                        int wc, int wo, float p1, float p2, int* pace, cudaStream_t stream) {
  const auto kernel = sgm_aggregate_wide_kernel<Tin, Tout, VPL>;
  const WideGeom g = wide_geom(VPL, p.block / 32, sizeof(Tin), sizeof(Tout), p.ring);
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       g.total);
  if (e != cudaSuccess) return e;
  if (pace != nullptr) {
    int dev = 0, sms = 0, per_sm = 0;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
        (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
        (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, p.block, g.total)) !=
            cudaSuccess)
      return e;
    if (static_cast<long long>(per_sm) * sms < p.grid) pace = nullptr;
  }
  kernel<<<p.grid, p.block, g.total, stream>>>(cost, out, D, S, K, p.ring, wc, wo, p1, p2,
                                                pace);
  return cudaGetLastError();
}

template <typename Tin, typename Tout>
cudaError_t launch_aggregate(const AggPlan& p, const void* cost, void* out, int D, int S,
                             int K, float p1, float p2, int* pace, cudaStream_t stream) {
  const Tin* c = static_cast<const Tin*>(cost);
  Tout* o = static_cast<Tout*>(out);
  if (p.wide) {
    // access widths: 4-byte cost pieces where the row pitch and the base
    // allow, else one element; out pieces the widest of 16 .. 1 bytes
    // within a row's tk columns that divides the pitch and the base
    const uintptr_t ca = reinterpret_cast<uintptr_t>(cost), oa = reinterpret_cast<uintptr_t>(out);
    const int wc = (static_cast<long long>(K) * sizeof(Tin)) % 4 == 0 && ca % 4 == 0
                       ? 4 : static_cast<int>(sizeof(Tin));
    int wo = p.block / 32 * static_cast<int>(sizeof(Tout));  // out: up to 16 bytes
    if (wo > 16) wo = 16;
    while (wo > static_cast<int>(sizeof(Tout)) &&
           ((static_cast<long long>(K) * sizeof(Tout)) % wo != 0 || oa % wo != 0))
      wo /= 2;
    switch (p.dpt) {
      case 5: return launch_wide<Tin, Tout, 5>(p, c, o, D, S, K, wc, wo, p1, p2, pace, stream);
      case 7: return launch_wide<Tin, Tout, 7>(p, c, o, D, S, K, wc, wo, p1, p2, pace, stream);
      case 9: return launch_wide<Tin, Tout, 9>(p, c, o, D, S, K, wc, wo, p1, p2, pace, stream);
    }
    return cudaErrorInvalidValue;
  }
  switch (p.dpt) {
    case 5:
      sgm_aggregate_lanes_kernel<Tin, Tout, 5>
          <<<p.grid, p.block, 0, stream>>>(c, o, D, S, K, p.G, p1, p2);
      break;
    case 9:
      sgm_aggregate_lanes_kernel<Tin, Tout, 9>
          <<<p.grid, p.block, 0, stream>>>(c, o, D, S, K, p.G, p1, p2);
      break;
    case 17:
      sgm_aggregate_lanes_kernel<Tin, Tout, 17>
          <<<p.grid, p.block, 0, stream>>>(c, o, D, S, K, p.G, p1, p2);
      break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <typename Tin>
cudaError_t aggregate_out(int out_type, const AggPlan& p, const void* cost, void* out,
                          int D, int S, int K, float p1, float p2, int* pace,
                          cudaStream_t stream) {
  switch (out_type) {
    case T_U8:
      return launch_aggregate<Tin, uint8_t>(p, cost, out, D, S, K, p1, p2, pace, stream);
    case T_BF16:
      return launch_aggregate<Tin, __nv_bfloat16>(p, cost, out, D, S, K, p1, p2, pace,
                                                  stream);
    case T_F32:
      return launch_aggregate<Tin, float>(p, cost, out, D, S, K, p1, p2, pace, stream);
  }
  return cudaErrorInvalidValue;
}

// -- B4 ------------------------------------------------------------------------

// A tile: TP_TB rows b of TP_ROW bytes of aT (128 uint8, 64 bfloat16 or
// 32 float32 values of a), staged in aT's own type. Byte x of row r sits
// in 16-byte chunk (x / 16) ^ (r / 8) of the row, so that the 8 rows a
// warp reads at once (8 apart) lie in 8 different chunks: no bank
// conflict, and every copy of up to 16 bytes stays whole.
constexpr int TP_ROW = 128;
constexpr int TP_TB = 64;
constexpr int TP_THREADS = 256;  // one 32-bit word x 8 rows of the tile each
constexpr int TP_STAGES = 3;     // planes of a block in flight

struct TransposePlan {
  int wa, wb, wo, dpb;  // bytes per access of aT, b, out; planes per block
};

// Byte x of row r of a staged tile of ROW-byte rows: its 16-byte chunk
// (x / 16) ^ (r >> SHIFT), modulo the row's chunks, so that rows a warp
// reads at once fall in different banks and every piece of up to 16 bytes
// stays whole. B4: 128-byte rows, SHIFT 3 (the 8 rows a warp reads, 8
// apart, in 8 chunks); B5 uses the same layout (see its section).
template <int ROW, int SHIFT>
__device__ __forceinline__ int tile_swizzle(int r, int x) {
  return r * ROW + ((((x >> 4) ^ (r >> SHIFT)) & (ROW / 16 - 1)) << 4) + (x & 15);
}

__device__ __forceinline__ int tp_swizzle(int r, int x) { return tile_swizzle<TP_ROW, 3>(r, x); }

template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (N == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(src),
                 "n"(N));
}

// Stage the tile of one plane: rows b0 .. b0 + ROWS - 1 of a volume from
// byte x0 of each row (pitch bytes a row), ROW bytes a row, swizzled
// (tile_swizzle), by THREADS threads, in W-byte pieces: cp.async for 4, 8
// and 16 bytes, a plain load and store below. W divides the pitch, so a
// piece lies wholly inside the row or wholly past its end.
template <int W, int ROW, int ROWS, int THREADS, int SHIFT>
__device__ __forceinline__ void tile_stage(uint8_t* tile, const uint8_t* plane,
                                           uint32_t pitch, int b0, int B, uint32_t x0) {
  constexpr int PER_ROW = ROW / W;
  // rolled: unrolled (2 to 32 pieces a thread), the pieces' addresses are
  // hoisted out of the plane loop and held in registers (up to 128 a
  // thread for uint8, and spills)
#pragma unroll 1
  for (int q = threadIdx.x; q < ROWS * PER_ROW; q += THREADS) {
    const int r = q / PER_ROW, x = (q % PER_ROW) * W;
    if (b0 + r >= B || x0 + x >= pitch) continue;
    uint8_t* dst = tile + tile_swizzle<ROW, SHIFT>(r, x);
    const uint8_t* src = plane + static_cast<uint32_t>(b0 + r) * pitch + x0 + x;
    if constexpr (W >= 4) {
      cp_async<W>(dst, src);
    } else if constexpr (W == 2) {
      *reinterpret_cast<uint16_t*>(dst) = __ldg(reinterpret_cast<const unsigned short*>(src));
    } else {
      *dst = __ldg(src);
    }
  }
}

// tile_stage at the runtime width w (a width the element size SA allows)
template <int SA, int ROW, int ROWS, int THREADS, int SHIFT>
__device__ __forceinline__ void stage_plane(int w, uint8_t* tile, const uint8_t* plane,
                                            uint32_t pitch, int b0, int B, uint32_t x0) {
  switch (w) {
    case 16: tile_stage<16, ROW, ROWS, THREADS, SHIFT>(tile, plane, pitch, b0, B, x0); break;
    case 8: tile_stage<8, ROW, ROWS, THREADS, SHIFT>(tile, plane, pitch, b0, B, x0); break;
    case 4: tile_stage<4, ROW, ROWS, THREADS, SHIFT>(tile, plane, pitch, b0, B, x0); break;
    case 2:
      if constexpr (SA <= 2) tile_stage<2, ROW, ROWS, THREADS, SHIFT>(tile, plane, pitch, b0, B, x0);
      break;
    default:
      if constexpr (SA == 1) tile_stage<1, ROW, ROWS, THREADS, SHIFT>(tile, plane, pitch, b0, B, x0);
      break;
  }
}

// NW words <-> global memory in W-byte pieces; piece q is used only when
// its bytes lie within the first `valid` (the row's end), else it reads 0.
template <int W, int NW>
__device__ __forceinline__ void tp_load(uint32_t (&w)[NW], const uint8_t* src, int valid) {
#pragma unroll
  for (int q = 0; q < NW * 4 / W; ++q) {
    if ((q + 1) * W > valid) continue;
    if constexpr (W == 16) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(src) + q);
      w[4 * q] = v.x, w[4 * q + 1] = v.y, w[4 * q + 2] = v.z, w[4 * q + 3] = v.w;
    } else if constexpr (W == 8) {
      const uint2 v = __ldg(reinterpret_cast<const uint2*>(src) + q);
      w[2 * q] = v.x, w[2 * q + 1] = v.y;
    } else if constexpr (W == 4) {
      w[q] = __ldg(reinterpret_cast<const unsigned*>(src) + q);
    } else if constexpr (W == 2) {
      w[q / 2] |= static_cast<uint32_t>(__ldg(reinterpret_cast<const unsigned short*>(src) + q))
                  << (16 * (q % 2));
    } else {
      w[q / 4] |= static_cast<uint32_t>(__ldg(src + q)) << (8 * (q % 4));
    }
  }
}

template <int W, int NW>
__device__ __forceinline__ void tp_store(uint8_t* dst, const uint32_t (&w)[NW], int valid) {
#pragma unroll
  for (int q = 0; q < NW * 4 / W; ++q) {
    if ((q + 1) * W > valid) continue;
    if constexpr (W == 16) {
      reinterpret_cast<uint4*>(dst)[q] =
          make_uint4(w[4 * q], w[4 * q + 1], w[4 * q + 2], w[4 * q + 3]);
    } else if constexpr (W == 8) {
      reinterpret_cast<uint2*>(dst)[q] = make_uint2(w[2 * q], w[2 * q + 1]);
    } else if constexpr (W == 4) {
      reinterpret_cast<unsigned*>(dst)[q] = w[q];
    } else {
      reinterpret_cast<unsigned short*>(dst)[q] =
          static_cast<unsigned short>(w[q / 2] >> (16 * (q % 2)));
    }
  }
}

// value i of a 32-bit word of packed T, and float -> the bits of T
template <typename T> __device__ __forceinline__ float unpack(uint32_t w, int i);
template <> __device__ __forceinline__ float unpack<uint8_t>(uint32_t w, int i) {
  return static_cast<float>((w >> (8 * i)) & 0xffu);
}
template <> __device__ __forceinline__ float unpack<__nv_bfloat16>(uint32_t w, int i) {
  return __bfloat162float(__ushort_as_bfloat16(static_cast<unsigned short>(w >> (16 * i))));
}
template <> __device__ __forceinline__ float unpack<float>(uint32_t w, int) {
  return __uint_as_float(w);
}
template <typename T> __device__ __forceinline__ uint32_t pack(float v);
template <> __device__ __forceinline__ uint32_t pack<__nv_bfloat16>(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}
template <> __device__ __forceinline__ uint32_t pack<float>(float v) { return __float_as_uint(v); }

// One block: one (a, b) tile through the d planes d0 .. d0 + dpb - 1 of
// its chunk, TP_STAGES - 1 planes of aT in flight (cp.async) ahead of the
// one it writes. A thread writes the 8 values b0 + 8j .. + 7 of AE rows a
// (AE = values of aT in 32 bits): one word of each of 8 tile rows, read
// back as AE 8-value vectors, with the addend's 8 values per row loaded
// before it waits for the tile.
template <typename Ta, typename Tout, bool HAS_B>
__global__ void __launch_bounds__(TP_THREADS)
    sgm_transpose_add_kernel(const Ta* __restrict__ aT, const Ta* __restrict__ bb,
                             Tout* __restrict__ out, int D, int B, int A, TransposePlan p) {
  constexpr int SA = sizeof(Ta), SO = sizeof(Tout);
  constexpr int AE = 4 / SA;      // a values per word of the tile
  constexpr int NB = 2 * SA;      // words of 8 values of Ta
  constexpr int NO = 2 * SO;      // words of 8 values of Tout
  constexpr int OE = 4 / SO;      // values of Tout per word
  __shared__ __align__(16) uint8_t tiles[TP_STAGES][TP_TB * TP_ROW];
  const int a0 = blockIdx.x * (TP_ROW / SA), b0 = blockIdx.y * TP_TB;
  const int d0 = blockIdx.z * p.dpb, n = min(p.dpb, D - d0);
  const uint32_t plane = static_cast<uint32_t>(A) * static_cast<uint32_t>(B);
  const uint32_t pitch_a = static_cast<uint32_t>(A) * SA;
  const int j = threadIdx.x & 7, ai = threadIdx.x >> 3;
  const int bl = b0 + 8 * j;                // this thread's first b
  const int left_a = (B - bl) * SA, left_o = (B - bl) * SO;  // bytes to the row end

  auto stage = [&](int i) {
    uint8_t* tile = tiles[i % TP_STAGES];
    const uint8_t* src =
        reinterpret_cast<const uint8_t*>(aT + static_cast<size_t>(d0 + i) * plane);
    const uint32_t x0 = static_cast<uint32_t>(a0) * SA;
    stage_plane<SA, TP_ROW, TP_TB, TP_THREADS, 3>(p.wa, tile, src, pitch_a, b0, B, x0);
  };

#pragma unroll
  for (int s = 0; s < TP_STAGES - 1; ++s) {
    if (s < n) stage(s);
    cp_async_commit();
  }
  for (int i = 0; i < n; ++i) {
    const size_t po = static_cast<size_t>(d0 + i) * plane;
    uint32_t bw[AE][NB];
#pragma unroll
    for (int e = 0; e < AE; ++e) {
#pragma unroll
      for (int k = 0; k < NB; ++k) bw[e][k] = 0;
      const int a = a0 + ai * AE + e;
      if (HAS_B && a < A) {
        const uint8_t* src = reinterpret_cast<const uint8_t*>(
            bb + po + static_cast<uint32_t>(a) * B + bl);
        switch (p.wb) {
          case 16: if constexpr (NB >= 4) tp_load<16>(bw[e], src, left_a); break;
          case 8: tp_load<8>(bw[e], src, left_a); break;
          case 4: tp_load<4>(bw[e], src, left_a); break;
          case 2: if constexpr (SA <= 2) tp_load<2>(bw[e], src, left_a); break;
          default: if constexpr (SA == 1) tp_load<1>(bw[e], src, left_a); break;
        }
      }
    }
    cp_async_wait<TP_STAGES - 2>();  // this thread's copies of plane i
    __syncthreads();                 // everyone's; and plane i - 1 is read
    if (i + TP_STAGES - 1 < n) stage(i + TP_STAGES - 1);
    cp_async_commit();

    const uint8_t* tile = tiles[i % TP_STAGES];
    uint32_t tw[8];
#pragma unroll
    for (int k = 0; k < 8; ++k)
      tw[k] = *reinterpret_cast<const uint32_t*>(tile + tp_swizzle(8 * j + k, 4 * ai));
#pragma unroll
    for (int e = 0; e < AE; ++e) {
      const int a = a0 + ai * AE + e;
      uint32_t ow[NO];
#pragma unroll
      for (int k = 0; k < NO; ++k) ow[k] = 0;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        float v = unpack<Ta>(tw[k], e);
        if (HAS_B) v = __fadd_rn(unpack<Ta>(bw[e][k / AE], k % AE), v);
        ow[k / OE] |= pack<Tout>(v) << (32 / OE * (k % OE));
      }
      if (a >= A) continue;
      uint8_t* dst = reinterpret_cast<uint8_t*>(out + po + static_cast<uint32_t>(a) * B + bl);
      switch (p.wo) {
        case 16: tp_store<16>(dst, ow, left_o); break;
        case 8: tp_store<8>(dst, ow, left_o); break;
        case 4: tp_store<4>(dst, ow, left_o); break;
        default: if constexpr (SO == 2) tp_store<2>(dst, ow, left_o); break;
      }
    }
  }
}

template <typename Ta, typename Tout>
cudaError_t launch_transpose_add(const void* aT, const void* b, void* out, int D, int B,
                                 int A, const TransposePlan& p, dim3 grid,
                                 cudaStream_t stream) {
  const Ta* a = static_cast<const Ta*>(aT);
  Tout* o = static_cast<Tout*>(out);
  if (b != nullptr)
    sgm_transpose_add_kernel<Ta, Tout, true><<<grid, TP_THREADS, 0, stream>>>(
        a, static_cast<const Ta*>(b), o, D, B, A, p);
  else
    sgm_transpose_add_kernel<Ta, Tout, false><<<grid, TP_THREADS, 0, stream>>>(
        a, nullptr, o, D, B, A, p);
  return cudaGetLastError();
}

template <typename Ta>
cudaError_t transpose_add_out(int out_type, const void* aT, const void* b, void* out, int D,
                              int B, int A, const TransposePlan& p, dim3 grid,
                              cudaStream_t stream) {
  switch (out_type) {
    case T_BF16:
      return launch_transpose_add<Ta, __nv_bfloat16>(aT, b, out, D, B, A, p, grid, stream);
    case T_F32: return launch_transpose_add<Ta, float>(aT, b, out, D, B, A, p, grid, stream);
  }
  return cudaErrorInvalidValue;
}

// an access width the kernel takes: a power of two from the element size
// up to cap that divides the row pitch and the base pointer
bool tp_width_ok(int w, int elem, int cap, long long pitch, const void* ptr) {
  return (w == 1 || w == 2 || w == 4 || w == 8 || w == 16) && w >= elem && w <= cap &&
         pitch % w == 0 && reinterpret_cast<uintptr_t>(ptr) % w == 0;
}

// -- B5 ------------------------------------------------------------------------

// A block owns an EP_T x EP_T pixel tile (x0 .., y0 ..) and walks all D
// planes. Per plane it stages two tiles into one slot of a ring of STAGES
// slots (2, 3 or 4; a slot is 8 KB for uint8, 16 KB for bfloat16, 32 KB for
// float32), each in its own type by cp.async: the agg_v tile (EP_T rows y of
// EP_T values x) and the agg_ht tile (EP_T rows x of EP_T values y), rows
// swizzled as B4's (tile_swizzle, SHIFT EP_SHIFT). A thread owns a 4 x 4
// micro-tile: it reads 4 values of x from each of 4 rows of the agg_v tile
// and 4 values of y from each of 4 rows of the agg_ht tile (one 4-value
// vector per row; warp w, lane l: tx = l % 8 + 8 (w % 2), ty = 4 (w / 2) +
// l / 8, which with SHIFT 2 keeps the reads within 1-2x of the least
// shared-memory wavefronts in all three types).
constexpr int EP_T = 64;
constexpr int EP_THREADS = 256;
constexpr int EP_SHIFT = 2;

struct EpiloguePlan {
  int wv, wh;  // bytes per access of agg_v, agg_ht
};

// The cost arithmetic of a storage type. uint8 sums in int: the values
// and their sums are integers below 2^24, so each comparison, and each
// value converted to float at the end, is float32's, and no conversion
// sits in the d loop. bfloat16 and float32 widen and add with __fadd_rn.
// get(w, e): value e of a 4-value vector held in words w.
template <typename T> struct EpCost;
template <> struct EpCost<uint8_t> {
  using C = int;
  static constexpr int inf = 1000000000;  // INF, exact as float
  static __device__ __forceinline__ int get(const uint32_t* w, int e) {
    return static_cast<int>((w[0] >> (8 * e)) & 0xffu);
  }
  static __device__ __forceinline__ int add(int a, int b) { return a + b; }
};
template <> struct EpCost<__nv_bfloat16> {
  using C = float;
  static constexpr float inf = INF;
  static __device__ __forceinline__ float get(const uint32_t* w, int e) {
    const uint32_t x = w[e >> 1];
    return __uint_as_float((e & 1) ? (x & 0xffff0000u) : (x << 16));
  }
  static __device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
};
template <> struct EpCost<float> {
  using C = float;
  static constexpr float inf = INF;
  static __device__ __forceinline__ float get(const uint32_t* w, int e) {
    return __uint_as_float(w[e]);
  }
  static __device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
};

// the NW words at a 4 NW-byte aligned shared-memory address
template <int NW>
__device__ __forceinline__ void ep_words(uint32_t (&w)[NW], const uint8_t* src) {
  if constexpr (NW == 4) {
    const uint4 v = *reinterpret_cast<const uint4*>(src);
    w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
  } else if constexpr (NW == 2) {
    const uint2 v = *reinterpret_cast<const uint2*>(src);
    w[0] = v.x, w[1] = v.y;
  } else {
    w[0] = *reinterpret_cast<const uint32_t*>(src);
  }
}

// One block: one tile through all D planes, STAGES - 1 planes in flight
// (cp.async) ahead of the one it reads, one block barrier a plane. The
// running state of the 16 pixels of a thread (best, bestd, c0, c2, prev)
// stays in registers; only the (H, W) map is written.
template <typename T, int STAGES>
__global__ void __launch_bounds__(EP_THREADS, 2)
    sgm_epilogue_kernel(const T* __restrict__ agg_v, const T* __restrict__ agg_ht,
                        float* __restrict__ out, int D, int H, int W, int subpixel,
                        int vec_out, EpiloguePlan p) {
  using E = EpCost<T>;
  using C = typename E::C;
  constexpr int S = sizeof(T), ROW = EP_T * S, TILE = EP_T * ROW;
  constexpr int NW = S;  // words of a 4-value vector
  extern __shared__ __align__(16) uint8_t ep_ring[];  // [STAGES][agg_v, agg_ht][TILE]
  const int x0 = blockIdx.x * EP_T, y0 = blockIdx.y * EP_T;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tx = (lane & 7) + 8 * (warp & 1), ty = 4 * (warp >> 1) + (lane >> 3);
  const uint32_t plane = static_cast<uint32_t>(H) * static_cast<uint32_t>(W);
  const uint32_t pitch_v = static_cast<uint32_t>(W) * S, pitch_h = static_cast<uint32_t>(H) * S;

  auto stage = [&](int d) {
    uint8_t* slot = ep_ring + (d % STAGES) * 2 * TILE;
    const size_t off = static_cast<size_t>(d) * plane;
    stage_plane<S, ROW, EP_T, EP_THREADS, EP_SHIFT>(
        p.wv, slot, reinterpret_cast<const uint8_t*>(agg_v + off), pitch_v, y0, H,
        static_cast<uint32_t>(x0) * S);
    stage_plane<S, ROW, EP_T, EP_THREADS, EP_SHIFT>(
        p.wh, slot + TILE, reinterpret_cast<const uint8_t*>(agg_ht + off), pitch_h, x0, W,
        static_cast<uint32_t>(y0) * S);
  };

  // pixel q = 4 j + i of this thread: (x0 + 4 tx + i, y0 + 4 ty + j)
  C best[16], c0[16], c2[16], prev[16];
  int bestd[16];
#pragma unroll
  for (int q = 0; q < 16; ++q) {
    best[q] = c0[q] = c2[q] = prev[q] = E::inf;
    bestd[q] = 0;
  }
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < D) stage(s);
    cp_async_commit();
  }
  for (int d = 0; d < D; ++d) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of plane d
    __syncthreads();              // everyone's; and plane d - 1 is read
    if (d + STAGES - 1 < D) stage(d + STAGES - 1);
    cp_async_commit();

    const uint8_t* tv = ep_ring + (d % STAGES) * 2 * TILE;
    const uint8_t* th = tv + TILE;
    uint32_t wh[4][NW];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      ep_words<NW>(wh[i], th + tile_swizzle<ROW, EP_SHIFT>(4 * tx + i, 4 * ty * S));
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t wv[NW];
      ep_words<NW>(wv, tv + tile_swizzle<ROW, EP_SHIFT>(4 * ty + j, 4 * tx * S));
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int q = 4 * j + i;
        const C c = E::add(E::get(wv, i), E::get(wh[i], j));
        if (c < best[q]) {
          c0[q] = prev[q];
          best[q] = c;
          bestd[q] = d;
        }
        if (bestd[q] == d - 1) c2[q] = c;
        prev[q] = c;
      }
    }
  }

  const int x = x0 + 4 * tx;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int y = y0 + 4 * ty + j;
    if (y >= H || x >= W) continue;
    float v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q = 4 * j + i;
      const float db = static_cast<float>(bestd[q]);
      v[i] = db;
      if (subpixel && bestd[q] >= 1 && bestd[q] <= D - 2) {
        const float b = static_cast<float>(best[q]), l = static_cast<float>(c0[q]),
                    r = static_cast<float>(c2[q]);
        const float denom = fmaxf(__fadd_rn(__fsub_rn(l, __fmul_rn(2.f, b)), r), 1e-6f);
        const float delta =
            fminf(fmaxf(__fdiv_rn(__fmul_rn(0.5f, __fsub_rn(l, r)), denom), -0.5f), 0.5f);
        v[i] = __fadd_rn(db, delta);
      }
    }
    float* o = out + static_cast<uint32_t>(y) * static_cast<uint32_t>(W) + x;
    if (vec_out) {
      *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (x + i < W) o[i] = v[i];
    }
  }
}

template <typename T, int STAGES>
cudaError_t launch_epilogue_ring(const void* agg_v, const void* agg_ht, void* out, int D,
                                 int H, int W, int subpixel, int vec_out,
                                 const EpiloguePlan& p, dim3 grid, cudaStream_t stream) {
  const int smem = STAGES * 2 * EP_T * EP_T * static_cast<int>(sizeof(T));
  const cudaError_t e = cudaFuncSetAttribute(
      sgm_epilogue_kernel<T, STAGES>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  sgm_epilogue_kernel<T, STAGES><<<grid, EP_THREADS, smem, stream>>>(
      static_cast<const T*>(agg_v), static_cast<const T*>(agg_ht), static_cast<float*>(out),
      D, H, W, subpixel, vec_out, p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_epilogue(const void* agg_v, const void* agg_ht, void* out, int D, int H,
                            int W, int subpixel, int vec_out, const EpiloguePlan& p,
                            int stages, dim3 grid, cudaStream_t stream) {
  switch (stages) {  // the ring depths compiled (_kernels.EPILOGUE_RINGS)
    case 2:
      return launch_epilogue_ring<T, 2>(agg_v, agg_ht, out, D, H, W, subpixel, vec_out, p,
                                        grid, stream);
    case 3:
      return launch_epilogue_ring<T, 3>(agg_v, agg_ht, out, D, H, W, subpixel, vec_out, p,
                                        grid, stream);
    case 4:
      return launch_epilogue_ring<T, 4>(agg_v, agg_ht, out, D, H, W, subpixel, vec_out, p,
                                        grid, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// out (D, S, K) = forward + backward aggregation of cost (D, S, K) along S,
// both contiguous; in_type / out_type: 0 uint8, 1 bfloat16, 2 float32. The
// launch plan: wide 0, the lane-group kernel with G lanes (a power of two
// <= 32) per scan column, dpt (5, 9 or 17) d values per lane, G * dpt >= D,
// block threads (a multiple of 32 up to AGG_BLOCK_MAX), grid blocks
// (exactly enough for K columns), ring 0, on a volume of fewer than 2^32
// elements; or wide 1, the wide kernel with G 32, dpt 5, 7 or 9 with
// 32 * dpt >= D, block 128, 256 or 512 (4, 8 or 16 columns), grid exactly enough
// for K columns and ring WIDE_RING_MIN .. WIDE_RING_MAX slots whose shared
// memory fits a block. Any other plan is refused. pace: WIDE_PACE_SLOTS
// zeroed int32 counters the wide kernel paces its blocks with, or null.
int sgm_aggregate(const void* cost, void* out, int D, int S, int K, int in_type,
                  int out_type, float p1, float p2, int wide, int G, int dpt,
                  int block, int grid, int ring, void* pace, void* stream) {
  if (D < 1 || D > AGG_DMAX || S < 1 || K < 1) return cudaErrorInvalidValue;
  const int ei = in_type == T_U8 ? 1 : in_type == T_BF16 ? 2 : in_type == T_F32 ? 4 : 0;
  const int eo = out_type == T_U8 ? 1 : out_type == T_BF16 ? 2 : out_type == T_F32 ? 4 : 0;
  if (ei == 0 || eo == 0) return cudaErrorInvalidValue;
  bool ok;
  if (wide) {
    const int tk = block / 32;
    ok = G == 32 && (dpt == 5 || dpt == 7 || dpt == 9) && 32 * dpt >= D &&
         (tk == 4 || tk == 8 || tk == 16) && block == 32 * tk &&
         grid == (K + tk - 1) / tk &&
         ring >= WIDE_RING_MIN && ring <= WIDE_RING_MAX &&
         wide_geom(dpt, tk, ei, eo, ring).total <= 232448;
  } else {
    ok = G >= 1 && G <= 32 && (G & (G - 1)) == 0 && G * dpt >= D && block >= 32 &&
         block <= AGG_BLOCK_MAX && block % 32 == 0 &&
         grid == (K + block / G - 1) / (block / G) && ring == 0 &&
         static_cast<unsigned long long>(D) * S * K <= 0xffffffffull;
  }
  if (!ok) return cudaErrorInvalidValue;
  const AggPlan p{wide, G, dpt, block, grid, ring};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* const pc = static_cast<int*>(pace);
  switch (in_type) {
    case T_U8: return aggregate_out<uint8_t>(out_type, p, cost, out, D, S, K, p1, p2, pc, s);
    case T_BF16:
      return aggregate_out<__nv_bfloat16>(out_type, p, cost, out, D, S, K, p1, p2, pc, s);
    case T_F32: return aggregate_out<float>(out_type, p, cost, out, D, S, K, p1, p2, pc, s);
  }
  return cudaErrorInvalidValue;
}

// out (D, A, B) = aT (D, B, A) transposed (+ b (D, A, B), of aT's type, when
// b is not null), all contiguous; in_type 0 uint8, 1 bfloat16, 2 float32;
// out_type 1 bfloat16 or 2 float32; A * B <= 2^30. The launch plan
// (_kernels.transpose_add_plan): wa / wb / wo bytes per access of aT, b
// (0 without b) and out, each a power of two from the element size up to
// 16 (wb up to 8 elements) dividing its row pitch and base pointer; dpb d
// planes per block; grid (gx, gy, gz) exactly (ceil(A / (128 / size of
// aT)), ceil(B / 64), ceil(D / dpb)). Any other plan is refused.
int sgm_transpose_add(const void* aT, const void* b, void* out, int D, int B, int A,
                      int in_type, int out_type, int wa, int wb, int wo, int dpb, int gx,
                      int gy, int gz, void* stream) {
  const int sa = in_type == T_U8 ? 1 : in_type == T_BF16 ? 2 : in_type == T_F32 ? 4 : 0;
  const int so = out_type == T_BF16 ? 2 : out_type == T_F32 ? 4 : 0;
  if (sa == 0 || so == 0 || D < 1 || B < 1 || A < 1 ||
      static_cast<long long>(A) * B > (1ll << 30) || dpb < 1)
    return cudaErrorInvalidValue;
  const bool ok =
      tp_width_ok(wa, sa, 16, static_cast<long long>(A) * sa, aT) &&
      (b == nullptr ? wb == 0
                    : tp_width_ok(wb, sa, 8 * sa < 16 ? 8 * sa : 16,
                                  static_cast<long long>(B) * sa, b)) &&
      tp_width_ok(wo, so, 16, static_cast<long long>(B) * so, out) &&
      gx == (A + TP_ROW / sa - 1) / (TP_ROW / sa) && gy == (B + TP_TB - 1) / TP_TB &&
      gz == (D + dpb - 1) / dpb && gy <= 65535 && gz <= 65535;
  if (!ok) return cudaErrorInvalidValue;
  const TransposePlan p{wa, wb, wo, dpb};
  const dim3 grid(gx, gy, gz);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (in_type) {
    case T_U8: return transpose_add_out<uint8_t>(out_type, aT, b, out, D, B, A, p, grid, s);
    case T_BF16:
      return transpose_add_out<__nv_bfloat16>(out_type, aT, b, out, D, B, A, p, grid, s);
    case T_F32: return transpose_add_out<float>(out_type, aT, b, out, D, B, A, p, grid, s);
  }
  return cudaErrorInvalidValue;
}

// out (H, W) float32 disparity from agg_v (D, H, W) and agg_ht (D, W, H) of one
// type (in_type 0 uint8, 1 bfloat16, 2 float32), all contiguous; subpixel 0
// gives the integer argmin; H * W <= 2^30. The launch plan
// (_kernels.sgm_epilogue_plan): wv / wh bytes per access of agg_v / agg_ht,
// each a power of two from the element size up to 16 dividing its row pitch
// (W / H elements) and base pointer; stages, the ring's slots (2, 3 or
// 4); grid (gx, gy) exactly (ceil(W / 64), ceil(H / 64)). Any other plan is
// refused.
int sgm_epilogue(const void* agg_v, const void* agg_ht, void* out, int D, int H, int W,
                 int in_type, int subpixel, int wv, int wh, int stages, int gx, int gy,
                 void* stream) {
  const int sz = in_type == T_U8 ? 1 : in_type == T_BF16 ? 2 : in_type == T_F32 ? 4 : 0;
  if (sz == 0 || D < 1 || H < 1 || W < 1 || static_cast<long long>(H) * W > (1ll << 30))
    return cudaErrorInvalidValue;
  const bool ok = tp_width_ok(wv, sz, 16, static_cast<long long>(W) * sz, agg_v) &&
                  tp_width_ok(wh, sz, 16, static_cast<long long>(H) * sz, agg_ht) &&
                  gx == (W + EP_T - 1) / EP_T && gy == (H + EP_T - 1) / EP_T && gy <= 65535;
  if (!ok) return cudaErrorInvalidValue;
  const int vec_out = W % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const EpiloguePlan p{wv, wh};
  const dim3 grid(gx, gy);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (in_type) {
    case T_U8:
      return launch_epilogue<uint8_t>(agg_v, agg_ht, out, D, H, W, subpixel, vec_out, p,
                                       stages, grid, s);
    case T_BF16:
      return launch_epilogue<__nv_bfloat16>(agg_v, agg_ht, out, D, H, W, subpixel, vec_out,
                                             p, stages, grid, s);
    case T_F32:
      return launch_epilogue<float>(agg_v, agg_ht, out, D, H, W, subpixel, vec_out, p,
                                     stages, grid, s);
  }
  return cudaErrorInvalidValue;
}

}  // extern "C"
