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
// of 2 columns, and loses to the staged kernel (d256: 27 ms against 8.5).
// Staged kernel (D > 136): one warp per (direction, scan column) carries
// the D path values, VPL = ceil(D / 32) contiguous d a lane, with the same
// shuffles over the whole warp. A block takes AGG_TK = 8 adjacent columns
// (16 warps: both directions), so each step's (D, 8) slab is read and
// written coalesced along k through shared memory with two block barriers
// a step; the next step's slab is prefetched into registers during the
// recursion. It meets in the middle as above, and is latency-bound: S
// dependent steps of barriers and shuffles per column.
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

// The largest D either kernel takes: the staged kernel's 32 lanes of 9 d
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

// Staged kernel (D > 8 lanes x 17). A warp per (direction, scan column)
// holds the D path values, vpl contiguous d a lane; AGG_TK adjacent
// columns a block, each step's (D, AGG_TK) slab read and written coalesced
// along k through shared memory, the next slab prefetched into registers
// during the recursion.
constexpr int AGG_TK = 8;                  // scan columns per block
constexpr int AGG_THREADS = 64 * AGG_TK;   // a warp per (direction, column)
constexpr int AGG_VMAX = 9;                // d values per lane: D <= 288
constexpr int AGG_EMAX = (AGG_DMAX * AGG_TK + AGG_THREADS - 1) / AGG_THREADS;

__host__ __device__ inline int agg_row(int vpl) { return 32 * vpl + 1; }

template <typename Tin, typename Tout>
__global__ void __launch_bounds__(AGG_THREADS)
    sgm_aggregate_staged_kernel(const Tin* __restrict__ cost, Tout* __restrict__ out,
                                int D, int S, int K, int vpl, float p1, float p2) {
  // cs / os: [direction][column][row of agg_row(vpl) floats], the staged
  // cost slab of this step and the path values to store
  extern __shared__ float smem[];
  const int R = agg_row(vpl);
  float* cs = smem;
  float* os = smem + 2 * AGG_TK * R;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int dir = warp / AGG_TK, col = warp % AGG_TK;
  const int k0 = blockIdx.x * AGG_TK;
  const size_t SK = static_cast<size_t>(S) * K;

  // element n of this thread: (d, c) = divmod(tid + n * AGG_THREADS, AGG_TK),
  // the same at every step for the cost loads, the stores and read-backs
  float cf[AGG_EMAX], cb[AGG_EMAX];  // cost at the forward / backward row
  Tout rf[AGG_EMAX], rb[AGG_EMAX];   // raw partials the next step adds to
#pragma unroll
  for (int n = 0; n < AGG_EMAX; ++n) {
    const int e = tid + n * AGG_THREADS, d = e / AGG_TK, k = k0 + e % AGG_TK;
    const bool ok = d < D && k < K;
    const size_t base = static_cast<size_t>(d) * SK + k;
    cf[n] = ok ? widen(cost[base]) : 0.f;
    cb[n] = ok ? widen(cost[base + static_cast<size_t>(S - 1) * K]) : 0.f;
  }

  float L[AGG_VMAX];
  for (int i = 0; i < S; ++i) {
    const int sf = i, sb = S - 1 - i;
#pragma unroll
    for (int n = 0; n < AGG_EMAX; ++n) {
      const int e = tid + n * AGG_THREADS, d = e / AGG_TK, c = e % AGG_TK;
      if (d < D) {
        cs[c * R + d] = cf[n];
        cs[(AGG_TK + c) * R + d] = cb[n];
      }
    }
    __syncthreads();
    if (i + 1 < S) {  // prefetch the next step's slab
#pragma unroll
      for (int n = 0; n < AGG_EMAX; ++n) {
        const int e = tid + n * AGG_THREADS, d = e / AGG_TK, k = k0 + e % AGG_TK;
        const bool ok = d < D && k < K;
        const size_t base = static_cast<size_t>(d) * SK + k;
        cf[n] = ok ? widen(cost[base + static_cast<size_t>(sf + 1) * K]) : 0.f;
        cb[n] = ok ? widen(cost[base + static_cast<size_t>(sb - 1) * K]) : 0.f;
      }
    }

    // the recursion of this warp's (direction, column)
    const float* cw = cs + (dir * AGG_TK + col) * R + lane * vpl;
    if (i == 0) {
#pragma unroll
      for (int j = 0; j < AGG_VMAX; ++j)
        L[j] = (j < vpl && lane * vpl + j < D) ? cw[j] : INF;
    } else {
      float m = INF, last = INF;
#pragma unroll
      for (int j = 0; j < AGG_VMAX; ++j) {
        m = fminf(m, L[j]);
        if (j == vpl - 1) last = L[j];
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) m = fminf(m, __shfl_xor_sync(FULL, m, o));
      float up_edge = __shfl_down_sync(FULL, L[0], 1);  // d = (lane+1)*vpl
      float dn_edge = __shfl_up_sync(FULL, last, 1);    // d = lane*vpl - 1
      if (lane == 31) up_edge = INF;
      if (lane == 0) dn_edge = INF;
      float nl[AGG_VMAX];
#pragma unroll
      for (int j = 0; j < AGG_VMAX; ++j) {
        if (j < vpl && lane * vpl + j < D) {
          const float up = (j == vpl - 1) ? up_edge : L[j + 1 < AGG_VMAX ? j + 1 : j];
          const float dn = (j == 0) ? dn_edge : L[j > 0 ? j - 1 : 0];
          const float best =
              fminf(fminf(L[j], __fadd_rn(fminf(up, dn), p1)), __fadd_rn(m, p2));
          nl[j] = __fsub_rn(__fadd_rn(cw[j], best), m);
        } else {
          nl[j] = INF;
        }
      }
#pragma unroll
      for (int j = 0; j < AGG_VMAX; ++j) L[j] = nl[j];
    }
    float* ow = os + (dir * AGG_TK + col) * R + lane * vpl;
#pragma unroll
    for (int j = 0; j < AGG_VMAX; ++j)
      if (j < vpl) ow[j] = L[j];
    __syncthreads();

    // store this step: raw where the other direction has not been yet, the
    // sum where it has (or is, in the middle row of an odd S)
#pragma unroll
    for (int n = 0; n < AGG_EMAX; ++n) {
      const int e = tid + n * AGG_THREADS, d = e / AGG_TK, c = e % AGG_TK;
      const int k = k0 + c;
      if (d < D && k < K) {
        const Tout vf = narrow<Tout>(os[c * R + d]);
        const Tout vb = narrow<Tout>(os[(AGG_TK + c) * R + d]);
        const size_t base = static_cast<size_t>(d) * SK + k;
        Tout* pf = out + base + static_cast<size_t>(sf) * K;
        Tout* pb = out + base + static_cast<size_t>(sb) * K;
        if (sf < sb) {
          *pf = vf;
          *pb = vb;
        } else if (sf == sb) {
          *pf = add_stored(vf, vb);
        } else {
          *pf = add_stored(rf[n], vf);
          *pb = add_stored(rb[n], vb);
        }
      }
    }
    // read back the raw partials the next step adds to: this thread stored
    // them at step S - 2 - i, at or before this one
    if (i + 1 < S && i + 1 > sb - 1) {
#pragma unroll
      for (int n = 0; n < AGG_EMAX; ++n) {
        const int e = tid + n * AGG_THREADS, d = e / AGG_TK, k = k0 + e % AGG_TK;
        if (d < D && k < K) {
          const size_t base = static_cast<size_t>(d) * SK + k;
          rf[n] = out[base + static_cast<size_t>(sf + 1) * K];
          rb[n] = out[base + static_cast<size_t>(sb - 1) * K];
        }
      }
    }
  }
}

// A launch plan (see sgm_aggregate below); checked before it is launched.
struct AggPlan {
  int staged, G, dpt, block, grid;
};

template <typename Tin, typename Tout>
cudaError_t launch_aggregate(const AggPlan& p, const void* cost, void* out, int D,
                             int S, int K, float p1, float p2, cudaStream_t stream) {
  const Tin* c = static_cast<const Tin*>(cost);
  Tout* o = static_cast<Tout*>(out);
  if (p.staged) {
    const size_t smem = sizeof(float) * 4 * AGG_TK * agg_row(p.dpt);
    sgm_aggregate_staged_kernel<Tin, Tout>
        <<<p.grid, AGG_THREADS, smem, stream>>>(c, o, D, S, K, p.dpt, p1, p2);
    return cudaGetLastError();
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
                          int D, int S, int K, float p1, float p2, cudaStream_t stream) {
  switch (out_type) {
    case T_U8:
      return launch_aggregate<Tin, uint8_t>(p, cost, out, D, S, K, p1, p2, stream);
    case T_BF16:
      return launch_aggregate<Tin, __nv_bfloat16>(p, cost, out, D, S, K, p1, p2, stream);
    case T_F32:
      return launch_aggregate<Tin, float>(p, cost, out, D, S, K, p1, p2, stream);
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

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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
// launch plan: staged 0, the lane-group kernel with G lanes (a power of two
// <= 32) per scan column, dpt (5, 9 or 17) d values per lane, G * dpt >= D,
// block threads (a multiple of 32 up to AGG_BLOCK_MAX), grid blocks
// (exactly enough for K columns), on a volume of fewer than 2^32 elements;
// or staged 1, the staged kernel with G 32, dpt ceil(D / 32), block
// AGG_THREADS and grid ceil(K / AGG_TK). Any other plan is refused.
int sgm_aggregate(const void* cost, void* out, int D, int S, int K, int in_type,
                  int out_type, float p1, float p2, int staged, int G, int dpt,
                  int block, int grid, void* stream) {
  if (D < 1 || D > AGG_DMAX || S < 1 || K < 1) return cudaErrorInvalidValue;
  bool ok;
  if (staged) {
    ok = G == 32 && dpt == (D + 31) / 32 && block == AGG_THREADS &&
         grid == (K + AGG_TK - 1) / AGG_TK;
  } else {
    ok = G >= 1 && G <= 32 && (G & (G - 1)) == 0 && G * dpt >= D && block >= 32 &&
         block <= AGG_BLOCK_MAX && block % 32 == 0 &&
         grid == (K + block / G - 1) / (block / G) &&
         static_cast<unsigned long long>(D) * S * K <= 0xffffffffull;
  }
  if (!ok) return cudaErrorInvalidValue;
  const AggPlan p{staged, G, dpt, block, grid};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (in_type) {
    case T_U8: return aggregate_out<uint8_t>(out_type, p, cost, out, D, S, K, p1, p2, s);
    case T_BF16:
      return aggregate_out<__nv_bfloat16>(out_type, p, cost, out, D, S, K, p1, p2, s);
    case T_F32: return aggregate_out<float>(out_type, p, cost, out, D, S, K, p1, p2, s);
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
