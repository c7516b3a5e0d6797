// SAD block matching with winner-take-all, hand-written for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of the SAD serving path:
//   sad_wta  <- steroscopic_hardware_tpu/ops/sad_pallas.py::_make_kernel
//               (disparity_pallas and disparity_pallas_batch)
//   sad_lr   <- steroscopic_hardware_tpu/ops/sad_pallas.py::_make_lr_kernel
//               (disparity_pallas_lr, with and without costs)
//
// What is computed (the bit contract of ops/sad_golden.py and ops/sad_xla.py):
//   cost_d(y, x) = sum over the (2h+1)^2 window around (y, x) of
//                  |L(y', x') - R(y', x' - d)|, h = block_size / 2, where a
//                  term adds 0 unless both pixels lie inside the image
//   dL(y, x)     = first-occurrence argmin over d in [0, maxD] of cost_d,
//                  a candidate being valid iff d <= x - h; 0 if none is
//   dR(y, xr)    = first-occurrence argmin over d of cost_d(y, xr + d),
//                  valid iff xr >= h and xr + d < W; 0 if none is
//   sad_wta writes uint8(dL * 255 / maxD); sad_lr writes dL and dR as int32
//   and, with costs, the masked costs at dL - 1, dL and dL + 1 (2^30 where
//   a cost does not exist or its candidate is invalid).
// Ties go to the smallest d through one packed key, cost * 512 + d, whose
// minimum orders exactly like (cost, d). cost <= 255 * 63 * 63 < 2^20 for
// the block sizes the wrapper accepts, so the key fits int32.
//
// What bounds it on the H100: integer instructions and shared-memory
// loads. Per pixel and d the function needs about 6 int32 operations with
// sliding window sums (2 more for the right map of sad_lr), against about
// 2 bytes of device memory read per pixel: compute-bound, never
// memory-bound. The first version of this file spent ~20x that bound: a
// block barrier per (d, row), a (2h+1)-term horizontal sum per pixel and
// d, the argmin state read and written in shared memory per pixel and d,
// and the right map computed by a second set of blocks that recomputed
// every window sum from R's side.
//
// Design (one kernel template, sad_kernel<MODE, KV, TH>, for both entry
// points; the launch plan is _kernels.sad_plan):
// - A block has DS warps and owns TH output rows and NOUT = 32 KV - 2h
//   output columns of one frame: 32 KV columns of vertical sums, the
//   outputs and their 2h halo. Its u8 tiles of L and R (R with maxD columns
//   more) are copied to shared memory once, in 16-byte cp.async chunks,
//   each row at its 16-byte phase in device memory on one linear grid (the
//   row pitch is congruent to W mod 16); one block barrier follows. Warp w
//   sweeps the d chunk [w (maxD+1) / DS, (w+1) (maxD+1) / DS) over the
//   whole tile, so warps never exchange data inside the (d, row) loop.
// - Vertical sums: lane l holds the (2h+1)-row window sums of columns
//   KV l .. KV l + KV - 1, two 16-bit sums to a register (255 * 63 <
//   2^16). A row term reads each tile's 4 bytes a column group as aligned
//   32-bit words, aligns them with one byte permute, and takes the four
//   |L - R| in one __vabsdiffu4. The sums are rebuilt per d over 2h+1 rows
//   and slid one row at a time: (2h + 1 + 2 (TH - 1)) / TH row terms per
//   output row.
// - Horizontal sums: the lane's sums, widened to 32 bits, are prefix-summed
//   in registers and across the warp (five shuffles; two rows at a time,
//   so their scans interleave), stored in warp-private shared rows under
//   one __syncwarp a row pair (two pairs of rows, alternating), and
//   cost = P(x + h) - P(x - h - 1): O(1) per pixel.
// - Lane l owns output slots l, l + 32, ..., l + 32 (KV - 1) of each of the
//   TH rows; the packed-key minimum (and with costs the neighbour tracking
//   of _make_lr_kernel) lives in its registers.
// - dR from the same costs, as the TPU kernel does it: a right accumulator
//   in drifting coordinates, A_d(j) = min(A_{d-1}(j - 1), key_d(j)), in
//   registers (one shuffle per slot group to shift by one column). An
//   entry that drifts past the last slot, and every entry at the end of
//   the warp's d chunk, is merged into dR by atomicMin on its packed key
//   (cost columns at x >= W, and slots past NOUT, are masked to 2^30
//   first). atomicMin is order-free, so dR is deterministic; sad_lr fills
//   dR with 2^30 before and keeps the low 9 bits after (two elementwise
//   kernels).
// - With DS > 1 the warps' dL minima meet by atomicMin in shared memory
//   after the sweep, behind the block's second and last barrier. sad_lr
//   with costs runs one warp per block (DS = 1) and writes from registers.
// All sums are exact integers.
//
// C interface (bound with ctypes): each entry point takes device pointers,
// strides and sizes, the launch plan (KV, TH, DS) and the CUDA stream,
// launches on that stream on the current device without synchronising,
// and returns cudaGetLastError() (cudaErrorInvalidValue for a plan outside
// the compiled set). The caller makes the inputs' device current (torch's
// device guard) and has called sad_init on it.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int BIG = 1 << 30;
constexpr int LANES = 32;
constexpr int MAX_DS = 4;            // warps per block (d chunks)
constexpr int MAX_H = 31;            // block_size <= 63
constexpr int MAX_DISPARITY = 511;
constexpr int SMEM_LIMIT = 232448;   // dynamic shared memory a block can have
constexpr unsigned FULL = 0xffffffffu;

enum Mode { WTA = 0, LR = 1, LR_COSTS = 2 };
// The compiled (mode, KV, TH), the ones _kernels.sad_plan picks
// (_kernels.SAD_COMPILED mirrors it). The per-pixel states (one, two, or
// five with costs) x KV x TH live in registers, which bounds TH.
constexpr int N_COMPILED = 4;
constexpr int COMPILED[N_COMPILED][3] = {
    {WTA, 8, 8}, {LR, 8, 4}, {LR_COSTS, 8, 2}, {LR_COSTS, 4, 4}};

__host__ __device__ inline int align16(int n) { return (n + 15) & ~15; }

// Bytes between two rows of a tile of `width` columns (see load_tile): room
// for a row's 16-byte phase, the word after its last column and the
// alignment of the next row, and congruent to W mod 16.
__host__ __device__ inline int tile_pitch(int width, int W) {
  return align16(width + 32) + 16 + (W & 15);
}

// Shared-memory layout of one block, in bytes from the start: the L tile,
// the R tile, DS warps' four prefix rows, and (not with costs) the dL merge
// row. _kernels.sad_smem mirrors it.
struct Layout {
  int TR;      // tile rows with halo: TH + 2h
  int NV;      // vertical-sum columns: 32 KV
  int MW;      // R-tile columns: NV + maxD
  int fpitch;  // bytes between two tile rows
  int mpitch;
  int prow;    // ints per prefix row: slot c + 4 holds P(c), slot 3 P(-1)
  int moving, pbuf, merge, total;
  __host__ __device__ Layout(int mode, int kv, int th, int h, int maxD,
                             int ds, int W) {
    TR = th + 2 * h;
    NV = LANES * kv;
    MW = NV + maxD;
    fpitch = tile_pitch(NV, W);
    mpitch = tile_pitch(MW, W);
    prow = NV + 4 + 64;  // + 64: reads of the slots past NOUT stay inside
    moving = align16(TR * fpitch);
    pbuf = moving + align16(TR * mpitch);
    merge = pbuf + ds * 4 * prow * 4;
    total = merge + (mode == LR_COSTS ? 0 : th * NV * 4);
  }
};

struct Args {
  const uint8_t* L;
  const uint8_t* R;
  uint8_t* out;  // sad_wta
  int* dL;       // sad_lr
  int* dR;       // sad_lr: packed keys, 2^30 on entry
  int* c_left;   // sad_lr with costs
  int* c_best;
  int* c_right;
  long long fstride_l, fstride_r;
  int H, W, h, maxD, ds;
};

__device__ inline void cp_async16(void* dst, uintptr_t src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

// 16-byte phase in device memory of image column gx of row gy (either may
// lie outside the image).
__device__ inline int phase_of(const uint8_t* img, int gy, int gx, int W) {
  return static_cast<int>(
      (reinterpret_cast<uintptr_t>(img) +
       static_cast<uintptr_t>(static_cast<long long>(gy) * W + gx)) & 15);
}

// Copies image columns [gx0, gx0 + width) of rows gy0 .. gy0 + TR - 1 into
// the tile, a row per warp in turn, so that pixel (r, c) of the tile lies
// at byte r * pitch + ph0 + c, ph0 = phase_of(img, gy0, gx0, W): row r
// keeps its 16-byte phase in device memory, (ph0 + r W) mod 16, and pitch
// is congruent to W mod 16 (tile_pitch), so every chunk is one aligned
// 16-byte cp.async and the rows stay on one linear grid. Only the chunks
// holding a pixel of the image are read (an aligned 16-byte chunk never
// crosses an allocation's end); bytes outside the image stay unset and are
// masked by the sweep. Rows outside the image are zero in both tiles, so
// their terms add 0.
__device__ void load_tile(const uint8_t* img, uint8_t* tile, int pitch,
                          int width, int gx0, int gy0, int TR, int H, int W) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nw = blockDim.x >> 5;
  const int lo = max(gx0, 0), hi = min(gx0 + width, W);
  const int ph0 = phase_of(img, gy0, gx0, W);
  for (int r = warp; r < TR; r += nw) {
    const int y = gy0 + r;
    // the row's 16-byte aligned start in the tile: column gx0 lands at
    // start + its phase = r * pitch + ph0
    uint8_t* row = tile + r * pitch + ph0 - ((ph0 + r * (W & 15)) & 15);
    if (y < 0 || y >= H || lo >= hi) {
      for (int i = lane * 16; i < align16(width + 32); i += LANES * 16)
        *reinterpret_cast<int4*>(row + i) = make_int4(0, 0, 0, 0);
      continue;
    }
    const uintptr_t rowp =
        reinterpret_cast<uintptr_t>(img) + static_cast<size_t>(y) * W;
    const uintptr_t base =
        (rowp + static_cast<intptr_t>(gx0)) & ~static_cast<uintptr_t>(15);
    const uintptr_t end = rowp + hi;
    for (uintptr_t c = ((rowp + lo) & ~static_cast<uintptr_t>(15)) + 16 * lane;
         c < end; c += 16 * LANES)
      cp_async16(row + (c - base), c);
  }
}

// The G 4-byte groups starting at byte p of a tile, each aligned into one
// word: G + 1 aligned 32-bit loads and G byte permutes.
template <int G>
__device__ inline void groups_at(const unsigned char* tile, int p,
                                 uint32_t (&out)[G]) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(tile) + (p >> 2);
  const unsigned sel = 0x3210u + 0x1111u * static_cast<unsigned>(p & 3);
  uint32_t lo = w[0];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const uint32_t hi = w[g + 1];
    out[g] = __byte_perm(lo, hi, sel);
    lo = hi;
  }
}

// MODE WTA: uint8 map; LR: dL and dR; LR_COSTS: dL, dR and the neighbour
// costs. KV vertical-sum columns and output slots per lane, TH output rows
// per block.
template <int MODE, int KV, int TH>
__global__ void __launch_bounds__(LANES * MAX_DS) sad_kernel(const Args a) {
  constexpr int NV = LANES * KV;  // vertical-sum columns == output slots
  constexpr int G = KV / 4;       // 4-column groups per lane
  extern __shared__ __align__(16) unsigned char smem[];
  const int h = a.h, maxD = a.maxD, H = a.H, W = a.W, ds = a.ds;
  const Layout lay(MODE, KV, TH, h, maxD, ds, W);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int f = blockIdx.z;
  const int nout = NV - 2 * h;  // output columns of the block
  const int x0 = blockIdx.x * nout, y0 = blockIdx.y * TH;
  const int gxF = x0 - h, gxM = gxF - maxD, gy = y0 - h;
  const uint8_t* Lf = a.L + f * a.fstride_l;
  const uint8_t* Rf = a.R + f * a.fstride_r;
  const unsigned char* Fs = smem;
  const unsigned char* Ms = smem + lay.moving;
  int* P = reinterpret_cast<int*>(smem + lay.pbuf) + warp * 4 * lay.prow;
  int* merged = reinterpret_cast<int*>(smem + lay.merge);
  load_tile(Lf, smem, lay.fpitch, NV, gxF, gy, lay.TR, H, W);
  load_tile(Rf, smem + lay.moving, lay.mpitch, lay.MW, gxM, gy, lay.TR, H, W);
  if (MODE != LR_COSTS)
    for (int s = threadIdx.x; s < TH * NV; s += blockDim.x) merged[s] = BIG;
  if (lane < 16) P[(lane >> 2) * lay.prow + (lane & 3)] = 0;  // P(-1): slot 3
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // byte of this lane's first vertical-sum column in tile row 0 (load_tile)
  const int cF = phase_of(Lf, gy, gxF, W) + lane * KV;
  const int cM = phase_of(Rf, gy, gxM, W) + lane * KV;
  const size_t frame = static_cast<size_t>(f) * H * W;
  const int n_d = maxD + 1;
  const int da = warp * n_d / ds, db = (warp + 1) * n_d / ds;
  const int B = 2 * h + 1;
  const int cb = lane * KV;  // this lane's first vertical-sum column
  // d limits of the lane's output slots: the left candidate d is valid iff
  // d <= lim; its cost feeds the right map iff also x < W (d <= limR)
  int lim[KV], limR[KV];
#pragma unroll
  for (int k = 0; k < KV; ++k) {
    const int j = k * LANES + lane, x = x0 + j;
    lim[k] = j < nout ? x - h : -1;
    limR[k] = x < W ? lim[k] : -1;
  }

  int best[TH][KV];
  int acc[TH][KV];                           // right accumulator (LR modes)
  int prev[TH][KV], cl[TH][KV], cr[TH][KV];  // neighbour tracking (costs)
#pragma unroll
  for (int yy = 0; yy < TH; ++yy)
#pragma unroll
    for (int k = 0; k < KV; ++k) {
      best[yy][k] = BIG;
      acc[yy][k] = BIG;
      prev[yy][k] = cl[yy][k] = cr[yy][k] = BIG;
    }

  for (int d = da; d < db; ++d) {
    const int moff = maxD - d;  // R-tile column of vertical-sum column 0
    // per group, the 16-bit halves of the columns whose pixels both lie in
    // the image: columns 0 and 2 (even), 1 and 3 (odd)
    uint32_t oke[G], oko[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      uint32_t m[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int xi = gxF + cb + 4 * g + i;
        m[i] = static_cast<unsigned>(xi) < static_cast<unsigned>(W) &&
                       static_cast<unsigned>(xi - d) < static_cast<unsigned>(W)
                   ? 0xffffu : 0u;
      }
      oke[g] = m[0] | m[2] << 16;
      oko[g] = m[1] | m[3] << 16;
    }
    // |L - R| of the lane's columns in tile row r, as two words of 16-bit
    // halves each group: columns 0 and 2 (even), 1 and 3 (odd)
    auto term = [&](int r, uint32_t (&ev)[G], uint32_t (&od)[G]) {
      uint32_t fb[G], mb[G];
      groups_at<G>(Fs, r * lay.fpitch + cF, fb);
      groups_at<G>(Ms, r * lay.mpitch + cM + moff, mb);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const uint32_t ad = __vabsdiffu4(fb[g], mb[g]);
        ev[g] = ad & 0x00ff00ffu;
        od[g] = (ad >> 8) & 0x00ff00ffu;
      }
    };
    uint32_t vse[G], vso[G];
#pragma unroll
    for (int g = 0; g < G; ++g) vse[g] = vso[g] = 0;
    for (int r = 0; r < B; ++r) {
      uint32_t ev[G], od[G];
      term(r, ev, od);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        vse[g] += ev[g];
        vso[g] += od[g];
      }
    }
    // two rows at a time: their prefix scans interleave, and one
    // __syncwarp publishes both
#pragma unroll
    for (int yy = 0; yy < TH; yy += 2) {
      int pre[2][KV], run[2];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = yy + half;
        if (row > 0) {
          uint32_t ei[G], oi[G], eo[G], oo[G];
          term(row + 2 * h, ei, oi);
          term(row - 1, eo, oo);
          // each 16-bit half stays a window sum (>= 0): no borrow crosses
#pragma unroll
          for (int g = 0; g < G; ++g) {
            vse[g] = vse[g] + ei[g] - eo[g];
            vso[g] = vso[g] + oi[g] - oo[g];
          }
        }
        // prefix sums over the tile's vertical-sum columns
        run[half] = 0;
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const uint32_t e = vse[g] & oke[g], o = vso[g] & oko[g];
          const int c4[4] = {static_cast<int>(e & 0xffff),
                             static_cast<int>(o & 0xffff),
                             static_cast<int>(e >> 16),
                             static_cast<int>(o >> 16)};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            run[half] += c4[i];
            pre[half][4 * g + i] = run[half];
          }
        }
      }
      int incl[2] = {run[0], run[1]};
#pragma unroll
      for (int o = 1; o < LANES; o <<= 1) {
        const int n0 = __shfl_up_sync(FULL, incl[0], o);
        const int n1 = __shfl_up_sync(FULL, incl[1], o);
        if (lane >= o) {
          incl[0] += n0;
          incl[1] += n1;
        }
      }
      // prefix rows alternate between two pairs, so a row is rewritten
      // only after the __syncwarp that follows its last read
      int* Pp = P + ((d * (TH / 2) + yy / 2) & 1) * 2 * lay.prow;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int off = incl[half] - run[half];
#pragma unroll
        for (int g = 0; g < G; ++g)
          *reinterpret_cast<int4*>(Pp + half * lay.prow + 4 + cb + 4 * g) =
              make_int4(pre[half][4 * g] + off, pre[half][4 * g + 1] + off,
                        pre[half][4 * g + 2] + off, pre[half][4 * g + 3] + off);
      }
      __syncwarp();

#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = yy + half, y = y0 + row;
        const int* Pr = Pp + half * lay.prow;
        int keyR[KV];
#pragma unroll
        for (int k = 0; k < KV; ++k) {
          const int j = k * LANES + lane;
          const int cost = Pr[j + 2 * h + 4] - Pr[j + 3];
          const bool valid = d <= lim[k];
          const int key = valid ? cost * 512 + d : BIG;
          if constexpr (MODE == LR_COSTS) {
            // the neighbour tracking of sad_pallas._make_lr_kernel: a win
            // takes the previous step's cost as its left neighbour and drops
            // the right one; the step after the winner supplies the right one
            const int masked = valid ? cost : BIG;
            const int b = best[row][k];
            if (key < b) {
              cl[row][k] = prev[row][k];
              cr[row][k] = BIG;
              best[row][k] = key;
            } else if ((b & 511) == d - 1) {
              cr[row][k] = masked;
            }
            prev[row][k] = masked;
          } else {
            best[row][k] = min(best[row][k], key);
          }
          keyR[k] = d <= limR[k] ? key : BIG;
        }
        if constexpr (MODE != WTA) {
          if (d > da) {
            // shift the accumulator one slot right; the last slot's entry
            // (xr = x0 + NV - d) leaves the block
            int rot[KV];
#pragma unroll
            for (int k = 0; k < KV; ++k)
              rot[k] = __shfl_sync(FULL, acc[row][k], (lane + LANES - 1) & 31);
            const int leaving = rot[KV - 1];
#pragma unroll
            for (int k = 0; k < KV; ++k)
              acc[row][k] = lane ? rot[k] : (k ? rot[k - 1] : BIG);
            if (lane == 0 && leaving < BIG && y < H)
              atomicMin(a.dR + frame + static_cast<size_t>(y) * W + x0 + NV - d,
                        leaving);
          }
#pragma unroll
          for (int k = 0; k < KV; ++k) acc[row][k] = min(acc[row][k], keyR[k]);
        }
      }
    }
  }

  if constexpr (MODE != WTA) {
    // the accumulator's entries at the end of the chunk: xr = x - (db - 1)
#pragma unroll
    for (int yy = 0; yy < TH; ++yy)
#pragma unroll
      for (int k = 0; k < KV; ++k) {
        const int y = y0 + yy;
        if (acc[yy][k] < BIG && y < H)
          atomicMin(a.dR + frame + static_cast<size_t>(y) * W + x0 +
                        k * LANES + lane - (db - 1),
                    acc[yy][k]);
      }
  }
  if constexpr (MODE == LR_COSTS) {
#pragma unroll
    for (int yy = 0; yy < TH; ++yy)
#pragma unroll
      for (int k = 0; k < KV; ++k) {
        const int y = y0 + yy, j = k * LANES + lane, x = x0 + j;
        if (y >= H || j >= nout || x >= W) continue;
        const size_t o = frame + static_cast<size_t>(y) * W + x;
        const int b = best[yy][k];
        a.dL[o] = b & 511;
        a.c_left[o] = cl[yy][k];
        a.c_best[o] = b == BIG ? BIG : (b >> 9);
        a.c_right[o] = cr[yy][k];
      }
  } else {
#pragma unroll
    for (int yy = 0; yy < TH; ++yy)
#pragma unroll
      for (int k = 0; k < KV; ++k) {
        int* m = merged + yy * NV + k * LANES + lane;
        if (ds == 1)
          *m = best[yy][k];
        else
          atomicMin(m, best[yy][k]);
      }
    __syncthreads();
    for (int s = threadIdx.x; s < TH * NV; s += blockDim.x) {
      const int y = y0 + s / NV, j = s % NV, x = x0 + j;
      if (y >= H || j >= nout || x >= W) continue;
      const size_t o = frame + static_cast<size_t>(y) * W + x;
      const int bd = merged[s] & 511;
      if constexpr (MODE == WTA)
        a.out[o] = static_cast<uint8_t>((bd * 255) / maxD);
      else
        a.dL[o] = bd;
    }
  }
}

__global__ void fill_kernel(int* p, long long n, int v) {
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += step)
    p[i] = v;
}

__global__ void keep_d_kernel(int* p, long long n) {
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += step)
    p[i] &= 511;
}

using KernelFn = void (*)(Args);

template <int I>
KernelFn compiled_at() {
  return sad_kernel<COMPILED[I][0], COMPILED[I][1], COMPILED[I][2]>;
}

// The compiled kernel for (mode, KV, TH), or null.
KernelFn kernel_for(int mode, int kv, int th) {
  static const KernelFn table[N_COMPILED] = {
      compiled_at<0>(), compiled_at<1>(), compiled_at<2>(), compiled_at<3>()};
  for (int i = 0; i < N_COMPILED; ++i)
    if (COMPILED[i][0] == mode && COMPILED[i][1] == kv && COMPILED[i][2] == th)
      return table[i];
  return nullptr;
}

// Checks the plan and launches the sweep; a plan outside the compiled set
// or the card's limits is refused.
int launch(int mode, const Args& a, int F, int kv, int th, int ds,
           cudaStream_t s) {
  const bool ds_ok = (ds == 1 || ds == 2 || ds == MAX_DS) &&
                     ds <= a.maxD + 1 && (mode != LR_COSTS || ds == 1);
  if (F < 1 || F > 65535 || a.H < 1 || a.W < 1 || a.h < 0 || a.h > MAX_H ||
      a.maxD < 1 || a.maxD > MAX_DISPARITY || !ds_ok)
    return cudaErrorInvalidValue;
  const KernelFn fn = kernel_for(mode, kv, th);
  const int nout = LANES * kv - 2 * a.h;
  const int gy = (a.H + th - 1) / th;
  const Layout lay(mode, kv, th, a.h, a.maxD, ds, a.W);
  if (fn == nullptr || gy > 65535 || lay.total > SMEM_LIMIT)
    return cudaErrorInvalidValue;
  fn<<<dim3((a.W + nout - 1) / nout, gy, F), LANES * ds, lay.total, s>>>(a);
  return cudaGetLastError();
}

int elementwise_blocks(long long n) {
  return static_cast<int>(std::min<long long>((n + 255) / 256, 8192));
}

}  // namespace

extern "C" {

// Opts every compiled sweep in, on the current device, to the dynamic
// shared memory of its largest launch in the envelope (h = 31, maxD = 511,
// the most warps its mode takes). Called once per device before its first
// launch; the launches themselves request only what their plan needs.
int sad_init() {
  for (int i = 0; i < N_COMPILED; ++i) {
    const int mode = COMPILED[i][0], kv = COMPILED[i][1], th = COMPILED[i][2];
    const int smem = Layout(mode, kv, th, MAX_H, MAX_DISPARITY,
                            mode == LR_COSTS ? 1 : MAX_DS, 15).total;
    const cudaError_t e = cudaFuncSetAttribute(
        kernel_for(mode, kv, th), cudaFuncAttributeMaxDynamicSharedMemorySize,
        std::min(smem, SMEM_LIMIT));
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

// uint8 disparity maps of F frames: out[f] = (dL * 255) / maxD.
// L and R: F frames of (H, W) rows of W bytes, frames fstride_* bytes apart;
// out: F contiguous (H, W) frames. Plan: (kv, th) COMPILED's sad_wta row,
// ds warps a block (1, 2 or 4, at most maxD + 1).
int sad_wta(const void* L, const void* R, void* out, long long fstride_l,
            long long fstride_r, int F, int H, int W, int block_size,
            int max_disparity, int kv, int th, int ds, void* stream) {
  Args a{};
  a.L = static_cast<const uint8_t*>(L);
  a.R = static_cast<const uint8_t*>(R);
  a.out = static_cast<uint8_t*>(out);
  a.fstride_l = fstride_l;
  a.fstride_r = fstride_r;
  a.H = H;
  a.W = W;
  a.h = block_size / 2;
  a.maxD = max_disparity;
  a.ds = ds;
  return launch(WTA, a, F, kv, th, ds, static_cast<cudaStream_t>(stream));
}

// int32 left- and right-referenced raw disparities of F frames and, when
// with_costs, the left map's (c_left, c_best, c_right); the three cost
// pointers may be null otherwise. Outputs: F contiguous (H, W) frames.
// Plan: (kv, th) one of COMPILED's rows for the mode, ds 1, 2 or 4 (at
// most maxD + 1; with costs 1). Three launches on the stream: dR filled
// with 2^30, the sweep, dR's keys cut to their d.
int sad_lr(const void* L, const void* R, void* dL, void* dR, void* c_left,
           void* c_best, void* c_right, long long fstride_l,
           long long fstride_r, int F, int H, int W, int block_size,
           int max_disparity, int with_costs, int kv, int th, int ds,
           void* stream) {
  Args a{};
  a.L = static_cast<const uint8_t*>(L);
  a.R = static_cast<const uint8_t*>(R);
  a.dL = static_cast<int*>(dL);
  a.dR = static_cast<int*>(dR);
  a.c_left = static_cast<int*>(c_left);
  a.c_best = static_cast<int*>(c_best);
  a.c_right = static_cast<int*>(c_right);
  a.fstride_l = fstride_l;
  a.fstride_r = fstride_r;
  a.H = H;
  a.W = W;
  a.h = block_size / 2;
  a.maxD = max_disparity;
  a.ds = ds;
  const int mode = with_costs ? LR_COSTS : LR;
  if (kernel_for(mode, kv, th) == nullptr || F < 1 || H < 1 || W < 1)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n = static_cast<long long>(F) * H * W;
  fill_kernel<<<elementwise_blocks(n), 256, 0, s>>>(a.dR, n, BIG);
  const int e = launch(mode, a, F, kv, th, ds, s);
  if (e != cudaSuccess) return e;
  keep_d_kernel<<<elementwise_blocks(n), 256, 0, s>>>(a.dR, n);
  return cudaGetLastError();
}

const char* sad_error_string(int error) {
  return cudaGetErrorString(static_cast<cudaError_t>(error));
}

}  // extern "C"
