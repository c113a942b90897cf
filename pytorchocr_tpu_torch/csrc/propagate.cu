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
// Design. A block owns a 32x32 interior and loads it with a 16-pixel halo on
// each side: a 64x64 int32 label tile and a 64x64 byte mask tile in shared
// memory (pixels outside the map load as label 0, mask 0, and stay 0 under
// both rules, which is the JAX kernel's zero border). The 16 rounds run in
// shared memory, double-buffered, with a barrier between rounds. A tile pixel
// at distance d from the tile edge is exact after round r whenever d >= r,
// so round r updates only the pixels with d >= r (whose neighbours have
// d >= r - 1: no read leaves the tile), and after round 16 the interior
// equals 16 global synchronous rounds exactly. Only the interior is written
// back. An in-place (single-buffer) update would be Gauss-Seidel and would
// change which label wins a contested pixel under the fill rule.
//
// The flag: round 16 updates exactly the interior, so "some interior pixel
// changed in round 16", OR-ed over the block with __syncthreads_or and into
// one int32 with atomicOr, is the JAX flag.
//
// What bounds it on an H100: shared-memory traffic and barriers, not device
// memory. At 736x1280 a round reads five int32 labels and one mask byte per
// updated pixel from shared memory and writes one label; the halo makes a
// block update sum_{r=1..16} (64 - 2r)^2 = 36,704 pixels for 16 x 1,024
// interior ones, 2.24x (4x without the shrinking region: (64/32)^2), and the
// tile loads read (64/32)^2 = 4x the interior from L2. 920 blocks of 512
// threads, 36 KB of shared memory each, 16 barriers. Later work: a wider
// interior (64x64 in a 96x96 tile halves the halo's share, needs dynamic
// shared memory), a row tile, or a persistent launch that runs the whole
// fixpoint and removes the host's flag read per launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRounds = 16;                  // rounds per launch == halo width
constexpr int kInner = 32;                   // interior side
constexpr int kTile = kInner + 2 * kRounds;  // 64: interior plus halo
constexpr int kThreadsY = 8;                 // tile rows are strided by 8

template <bool kFillOnly>
__global__ void __launch_bounds__(kTile * kThreadsY)
propagate_tile(const int* __restrict__ labels, const uint8_t* __restrict__ mask,
               int* __restrict__ out, int* __restrict__ changed, int H, int W) {
  __shared__ int s_lbl[2][kTile][kTile];
  __shared__ uint8_t s_msk[kTile][kTile];
  const int tx = threadIdx.x;  // tile column: neighbouring threads, neighbouring addresses
  const int ty = threadIdx.y;
  const int y0 = blockIdx.y * kInner - kRounds;  // map row of tile row 0
  const int gx = blockIdx.x * kInner - kRounds + tx;
  const bool col_in = gx >= 0 && gx < W;

  for (int i = ty; i < kTile; i += kThreadsY) {
    const int gy = y0 + i;
    int v = 0;
    uint8_t m = 0;
    if (col_in && gy >= 0 && gy < H) {
      const size_t g = static_cast<size_t>(gy) * W + gx;
      v = labels[g];
      m = mask[g] != 0;
    }
    s_lbl[0][i][tx] = v;
    s_msk[i][tx] = m;
  }
  __syncthreads();

  bool diff = false;
#pragma unroll 1
  for (int r = 1; r <= kRounds; ++r) {
    const int(*src)[kTile] = s_lbl[(r - 1) & 1];
    int(*dst)[kTile] = s_lbl[r & 1];
    if (tx >= r && tx < kTile - r) {
      for (int i = ty; i < kTile - r; i += kThreadsY) {
        if (i < r) continue;
        const int c = src[i][tx];
        const int best = max(max(c, max(src[i - 1][tx], src[i + 1][tx])),
                             max(src[i][tx - 1], src[i][tx + 1]));
        int v;
        if (kFillOnly) {
          v = (c == 0 && s_msk[i][tx]) ? best : c;
        } else {
          v = s_msk[i][tx] ? best : 0;
        }
        dst[i][tx] = v;
        if (r == kRounds && v != c) diff = true;  // round 16 updates the interior only
      }
    }
    __syncthreads();
  }

  const int(*fin)[kTile] = s_lbl[kRounds & 1];
  if (col_in && tx >= kRounds && tx < kRounds + kInner) {
    for (int i = kRounds + ty; i < kRounds + kInner; i += kThreadsY) {
      const int gy = y0 + i;  // >= 0 for interior rows
      if (gy < H) out[static_cast<size_t>(gy) * W + gx] = fin[i][tx];
    }
  }
  if (__syncthreads_or(diff) && tx == 0 && ty == 0) atomicOr(changed, 1);
}

}  // namespace

// C entry point, bound with ctypes by pytorchocr_tpu_torch/ops/propagate.py.
// Launches on `stream`, does not synchronise, allocates nothing. *changed is
// set to 1 if the last round changed any pixel (the caller zeroes it).
// Returns cudaGetLastError().
extern "C" int propagate_launch(const int* labels, const uint8_t* mask, int* out,
                                int* changed, int H, int W, int fill_only,
                                cudaStream_t stream) {
  if (H <= 0 || W <= 0) return 0;
  const dim3 grid((W + kInner - 1) / kInner, (H + kInner - 1) / kInner);
  const dim3 block(kTile, kThreadsY);
  if (fill_only) {
    propagate_tile<true><<<grid, block, 0, stream>>>(labels, mask, out, changed, H, W);
  } else {
    propagate_tile<false><<<grid, block, 0, stream>>>(labels, mask, out, changed, H, W);
  }
  return static_cast<int>(cudaGetLastError());
}
