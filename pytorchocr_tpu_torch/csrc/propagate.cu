// Label propagation: 16 synchronous rounds of masked 4-neighbour label-max
// spreading on an int32 (H, W) map, in one launch.
//
// Replaces the TPU kernel pytorchocr_tpu/ops/pallas_propagate.py:
// _propagate_kernel (launched by propagate_rounds_pallas, driven by
// spread_labels_fixpoint). One round, with neighbours outside the map as 0
// and best = max(self, up, down, left, right):
//   fill rule (PSE/PAN expansion): a masked pixel labelled 0 takes best;
//   CC rule: every masked pixel takes best, unmasked pixels become 0.
// The launch also reports whether its last round changed any pixel: a round
// that changes nothing is a fixpoint, and the caller stops.
//
// Tiles. A block owns a 64x64 interior and loads it with a 16-pixel halo on
// each side, a 96x96 tile (pixels outside the map load as label 0, mask 0,
// and stay 0 under both rules: the JAX kernel's zero border). A tile pixel at
// distance d from the tile edge is exact after round r whenever d >= r, so
// after round 16 the interior equals 16 global synchronous rounds, whatever
// the ring outside d >= r holds; only the interior is written back. Every
// round updates the whole tile from the last round's values (a tile border
// of 0): the rounds stay synchronous, as an in-place update would be
// Gauss-Seidel and would change which label wins a contested pixel.
//
// What bounds it on an H100: the traffic through the SM's shared-memory
// crossbar (loads, stores and warp shuffles) and the warps in flight to
// hide it. Device memory moves 9 B a pixel (2.5 us at 736x1280) and the
// INT32 work is 16 rounds of ~6 operations a masked pixel (3-4 us); a
// round in a shared-memory tile costs a pixel 3 loads and a store, and
// such designs measured ~2.7 us a round at 736x1280. So:
//   * one warp spans the tile's 96 columns, 3 a lane, and holds 8 rows of
//     them in registers: the rows above and below a pixel are registers,
//     the left and right neighbours inside a lane too, and across lanes one
//     shuffle each way serves 3 pixels. Only the strips' top and bottom rows
//     go through shared memory, double-buffered by round parity, with zero
//     strips for the tile's border. 12 warps a block keep 24 pixels a
//     thread, so 240 blocks at 736x1280 still run ~22 warps an SM;
//   * the row loop is unrolled and branch-free, so rows overlap;
//   * a tile whose interior has nothing a round can change (fill: no masked
//     pixel labelled 0; CC: no masked pixel) writes its answer at once
//     (fill: the input, CC: 0): on text pages most tiles are background;
//   * a tile stops when a round changes none of its pixels: the next round
//     would read the same values. The round's barrier finds it.
// The flag: some interior pixel changed in round 16, OR-ed over the block
// and into one int32 with atomicOr (the JAX flag); a tile that stopped
// earlier, or skipped its rounds, had no change in round 16.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kRounds = 16;                      // rounds per launch == halo width
constexpr int kCols = 3;                         // tile columns a lane holds
constexpr int kTile = 32 * kCols;                // 96: one warp spans the tile
constexpr int kInner = kTile - 2 * kRounds;      // 64: interior side
constexpr int kRows = 8;                         // tile rows a warp holds
constexpr int kStrips = kTile / kRows;           // 12 warps down a tile
static_assert(kRows * kCols <= 32, "a thread's pixel bits fill one 32-bit register");

// Block: kStrips warps down a 96x96 tile; warp wy owns tile rows
// [kRows wy, +kRows) across the whole tile, lane l tile columns
// [3 l, 3 l + 3), one pixel per register. Shared memory carries only the
// strips' top and bottom rows, by round parity, with a zero strip above and
// below the tile; the tile's left and right borders are 0 in registers.
template <bool kFill>
__global__ void __launch_bounds__(32 * kStrips)
propagate_tile(const int* __restrict__ labels, const uint8_t* __restrict__ mask,
               int* __restrict__ out, int* __restrict__ changed, int H, int W) {
  __shared__ int s_row[2][kStrips + 2][2][kTile];  // [parity][strip + 1][top, bottom][col]
  const int lane = threadIdx.x, wy = threadIdx.y;
  const int i0 = wy * kRows, j0 = lane * kCols;  // this thread's first tile row and column
  const int y0 = blockIdx.y * kInner - kRounds;  // map row of tile row 0
  const int x0 = blockIdx.x * kInner - kRounds;  // map column of tile column 0

  int c[kRows][kCols];
  unsigned mbits = 0, inner = 0;  // bit kCols k + j: masked; interior
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const int gy = y0 + i0 + k;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int gx = x0 + j0 + j, bit = kCols * k + j;
      c[k][j] = 0;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
        const size_t g = static_cast<size_t>(gy) * W + gx;
        c[k][j] = labels[g];
        mbits |= static_cast<unsigned>(mask[g] != 0) << bit;
      }
      const bool in = i0 + k >= kRounds && i0 + k < kRounds + kInner &&
                      j0 + j >= kRounds && j0 + j < kRounds + kInner;
      inner |= static_cast<unsigned>(in) << bit;
    }
  }
  bool work = false;  // an interior pixel that a round could change
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      if (((mbits & inner) >> (kCols * k + j)) & 1u && (!kFill || c[k][j] == 0)) work = true;
    }
  }

  // round 0's strip edges, and the zero strips of both parities
  if (wy < 2) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        s_row[q][wy == 0 ? 0 : kStrips + 1][0][j0 + j] = 0;
        s_row[q][wy == 0 ? 0 : kStrips + 1][1][j0 + j] = 0;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    s_row[0][wy + 1][0][j0 + j] = c[0][j];
    s_row[0][wy + 1][1][j0 + j] = c[kRows - 1][j];
  }
  bool flag = false;
  const bool run = __syncthreads_or(work);
  if (run) {
#pragma unroll 1
    for (int r = 1; r <= kRounds; ++r) {
      const int p = (r - 1) & 1;  // the parity of the last round's edges
      unsigned dbits = 0;         // pixels that changed
      int up[kCols], below[kCols];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        up[j] = s_row[p][wy][1][j0 + j];         // the strip above's bottom row
        below[j] = s_row[p][wy + 2][0][j0 + j];  // the strip below's top row
      }
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        int cur[kCols];
#pragma unroll
        for (int j = 0; j < kCols; ++j) cur[j] = c[k][j];
        // every lane shuffles; the tile's left and right borders are 0
        int lf = __shfl_up_sync(kFull, cur[kCols - 1], 1);
        int rt = __shfl_down_sync(kFull, cur[0], 1);
        lf = lane == 0 ? 0 : lf;
        rt = lane == 31 ? 0 : rt;
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          const int down = k + 1 < kRows ? c[k + 1][j] : below[j];
          const int left = j == 0 ? lf : cur[j - 1];
          const int right = j + 1 == kCols ? rt : cur[j + 1];
          const int best = max(max(cur[j], max(up[j], down)), max(left, right));
          const bool m = (mbits >> (kCols * k + j)) & 1u;
          const int v = kFill ? ((cur[j] == 0 && m) ? best : cur[j]) : (m ? best : 0);
          dbits |= static_cast<unsigned>(v != cur[j]) << (kCols * k + j);
          up[j] = cur[j];
          c[k][j] = v;
        }
      }
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        s_row[r & 1][wy + 1][0][j0 + j] = c[0][j];
        s_row[r & 1][wy + 1][1][j0 + j] = c[kRows - 1][j];
      }
      // every tile pixel is updated, the ring outside d >= r too (with the
      // tile's zero border): a tile in which nothing changes stays so
      const bool any = __syncthreads_or(dbits != 0);  // also publishes the edges
      if (!any) break;
      if (r == kRounds) flag = __syncthreads_or((dbits & inner) != 0);
    }
  }

  // the interior pixels of this thread; a tile that skipped its rounds
  // still holds its input, the answer of the fill rule, and its interior is
  // unmasked, so the CC rule makes it 0
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int gy = y0 + i0 + k, gx = x0 + j0 + j;
      if ((inner >> (kCols * k + j)) & 1u && gy < H && gx < W) {
        out[static_cast<size_t>(gy) * W + gx] = (kFill || run) ? c[k][j] : 0;
      }
    }
  }
  if (flag && lane == 0 && wy == 0) atomicOr(changed, 1);
}

}  // namespace

// C entry point, bound with ctypes by pytorchocr_tpu_torch/ops/propagate.py.
// Launches on `stream`, does not synchronise, allocates nothing. *changed is
// zeroed here and set to 1 if the last round changed any pixel. Returns
// cudaGetLastError() (or the memset's error).
extern "C" int propagate_launch(const int* labels, const uint8_t* mask, int* out,
                                int* changed, int H, int W, int fill_only,
                                cudaStream_t stream) {
  const cudaError_t err = cudaMemsetAsync(changed, 0, sizeof(int), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (H <= 0 || W <= 0) return 0;
  const dim3 grid((W + kInner - 1) / kInner, (H + kInner - 1) / kInner);
  const dim3 block(32, kStrips);
  if (fill_only) {
    propagate_tile<true><<<grid, block, 0, stream>>>(labels, mask, out, changed, H, W);
  } else {
    propagate_tile<false><<<grid, block, 0, stream>>>(labels, mask, out, changed, H, W);
  }
  return static_cast<int>(cudaGetLastError());
}
