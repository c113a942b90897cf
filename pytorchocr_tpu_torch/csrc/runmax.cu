// Segmented run-max scan along one axis of an int32 (H, W) label map.
//
// Replaces the TPU kernel pytorchocr_tpu/ops/pallas_propagate.py:_runmax_kernel
// (launched by _runmax_band, wrapped by segmented_runmax_pallas). Along `axis`,
// every pixel of a maximal contiguous masked run gets max(0, max of the run);
// unmasked pixels get 0. Connected-component labelling alternates the two axes
// until nothing changes (pytorchocr_tpu_torch/ops/cc_label.py).
//
// What bounds it on an H100: bytes. Per pixel the pass must read 4 B of labels
// and 1 B of mask and write 4 B, about 8.5 MB for a 736x1280 page, which is
// ~2.5 us at 3.35 TB/s; the arithmetic is a handful of integer max/selects.
// The map fits in the 50 MB L2, so the second read of each pass below mostly
// hits L2. What this first design does about it:
//   * every load and store is coalesced: along axis 1 a warp owns a row and
//     its lanes sit on neighbouring columns; along axis 0 a warp spans 32
//     neighbouring columns and each thread walks down its column;
//   * there is no shared-memory tile of the whole line, so any H and W work
//     (the TPU kernel's VMEM band limit does not carry over);
//   * the changed flag of the fixpoint loop is fused into the axis-0 launch
//     (one int32 set when any output differs from `prev`), instead of a
//     separate comparison pass.
// Later work: keep the map on chip across alternations (one persistent launch
// for the whole fixpoint), and read each pixel once per pass.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kRowWarps = 8;   // rows (warps) per block for axis 1
constexpr int kRowChunks = 4;  // 32-wide chunks loaded together: loads in flight
constexpr int kColTile = 32;   // columns per block for axis 0
constexpr int kColSegs = 16;   // row segments per column for axis 0

// Inclusive segmented max-scan across the lanes of a warp. `x` is the value
// (0 at a boundary), `f` is 1 where a run boundary lies at or before the lane
// within this chunk. After the scan, a lane with f == 0 holds the max of all
// lanes before it in the chunk; with f == 1, the max since the last boundary.
__device__ __forceinline__ void warp_segmented_max(int& x, int& f, int lane) {
#pragma unroll
  for (int s = 1; s < 32; s <<= 1) {
    int ox = __shfl_up_sync(kFull, x, s);
    int of = __shfl_up_sync(kFull, f, s);
    if (lane >= s) {
      if (!f) x = max(x, ox);
      f |= of;
    }
  }
}

// axis 1: one warp per row, the row walked in chunks of 32 * kRowChunks with a
// carried running max; forward writes its result to `out`, backward combines.
__global__ void runmax_rows(const int* __restrict__ vals,
                            const uint8_t* __restrict__ mask,
                            int* __restrict__ out, int H, int W) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowWarps + (threadIdx.x >> 5);
  if (row >= H) return;  // whole warp leaves together
  const size_t off = static_cast<size_t>(row) * W;
  const int* v = vals + off;
  const uint8_t* m = mask + off;
  int* o = out + off;

  int carry = 0;
  for (int base = 0; base < W; base += 32 * kRowChunks) {
    int x[kRowChunks], f[kRowChunks];
#pragma unroll
    for (int k = 0; k < kRowChunks; ++k) {
      const int i = base + k * 32 + lane;
      const bool in = i < W && m[i];
      x[k] = in ? v[i] : 0;
      f[k] = in ? 0 : 1;  // unmasked or past the end: a boundary
    }
#pragma unroll
    for (int k = 0; k < kRowChunks; ++k) {
      warp_segmented_max(x[k], f[k], lane);
      if (!f[k]) x[k] = max(x[k], carry);
      carry = __shfl_sync(kFull, x[k], 31);
      const int i = base + k * 32 + lane;
      if (i < W) o[i] = x[k];
    }
  }
  __syncwarp();  // the backward pass reads forward results of other lanes

  carry = 0;
  for (int base = 0; base < W; base += 32 * kRowChunks) {
    int x[kRowChunks], f[kRowChunks];
    bool mk[kRowChunks];
#pragma unroll
    for (int k = 0; k < kRowChunks; ++k) {
      const int j = W - 1 - (base + k * 32 + lane);
      mk[k] = j >= 0 && m[j];
      x[k] = mk[k] ? v[j] : 0;
      f[k] = mk[k] ? 0 : 1;
    }
#pragma unroll
    for (int k = 0; k < kRowChunks; ++k) {
      warp_segmented_max(x[k], f[k], lane);
      if (!f[k]) x[k] = max(x[k], carry);
      carry = __shfl_sync(kFull, x[k], 31);
      const int j = W - 1 - (base + k * 32 + lane);
      if (j >= 0) o[j] = mk[k] ? max(o[j], x[k]) : 0;
    }
  }
}

// axis 0: a block owns kColTile neighbouring columns; the rows are cut into
// kColSegs segments, one thread per (column, segment). Pass 1 walks each
// segment down, storing the segment-local forward max and the segment's
// summary (max before its first boundary, max after its last one, whether it
// holds a boundary). The summaries give each segment the runs that enter it
// from above and below. Pass 2 walks each segment up, forming the backward max
// on the fly and combining it with the forward one.
__global__ void runmax_cols(const int* __restrict__ vals,
                            const uint8_t* __restrict__ mask,
                            int* __restrict__ out, const int* __restrict__ prev,
                            int* __restrict__ changed, int H, int W) {
  __shared__ int s_head[kColSegs][kColTile];
  __shared__ int s_tail[kColSegs][kColTile];
  __shared__ int s_hasb[kColSegs][kColTile];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int c = blockIdx.x * kColTile + tx;
  const int seglen = (H + kColSegs - 1) / kColSegs;
  const int r0 = min(ty * seglen, H);
  const int r1 = min(r0 + seglen, H);
  const bool live = c < W;

  int head = 0, tail = 0, first_b = r1;
  bool hasb = false;
  if (live) {
    for (int r = r0; r < r1; ++r) {
      const size_t i = static_cast<size_t>(r) * W + c;
      if (mask[i]) {
        tail = max(tail, vals[i]);
      } else {
        if (!hasb) {
          head = tail;
          first_b = r;
        }
        hasb = true;
        tail = 0;
      }
      out[i] = tail;
    }
    if (!hasb) head = tail;
  }
  s_head[ty][tx] = head;
  s_tail[ty][tx] = tail;
  s_hasb[ty][tx] = hasb;
  __syncthreads();
  if (!live) return;

  // empty segments (past H) hold zeros and no boundary: they pass runs through
  int cf = 0;  // the run entering from above
  for (int k = ty - 1; k >= 0; --k) {
    cf = max(cf, s_tail[k][tx]);
    if (s_hasb[k][tx]) break;
  }
  int cb = 0;  // the run entering from below
  for (int k = ty + 1; k < kColSegs; ++k) {
    cb = max(cb, s_head[k][tx]);
    if (s_hasb[k][tx]) break;
  }

  bool diff = false;
  int run = cb;
  for (int r = r1 - 1; r >= r0; --r) {
    const size_t i = static_cast<size_t>(r) * W + c;
    int res = 0;
    if (mask[i]) {
      run = max(run, vals[i]);
      int fwd = out[i];
      if (r < first_b) fwd = max(fwd, cf);
      res = max(fwd, run);
    } else {
      run = 0;
    }
    out[i] = res;
    if (prev != nullptr && res != prev[i]) diff = true;
  }
  if (changed != nullptr && diff) atomicOr(changed, 1);
}

}  // namespace

// C entry point, bound with ctypes by pytorchocr_tpu_torch/ops/runmax.py.
// Launches on `stream`, does not synchronise, allocates nothing. `prev` and
// `changed` may be null; given (axis 0 only: the fixpoint loop reads the flag
// once per alternation, after its column pass), *changed is set to 1 if any
// output differs from prev (the caller zeroes it). Returns cudaGetLastError(),
// or cudaErrorInvalidValue for a flag asked of axis 1.
extern "C" int runmax_launch(const int* vals, const uint8_t* mask, int* out,
                             const int* prev, int* changed, int H, int W,
                             int axis, cudaStream_t stream) {
  if (H <= 0 || W <= 0) return 0;
  if (axis == 1) {
    if (prev != nullptr || changed != nullptr) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const dim3 grid((H + kRowWarps - 1) / kRowWarps);
    runmax_rows<<<grid, kRowWarps * 32, 0, stream>>>(vals, mask, out, H, W);
  } else {
    const dim3 grid((W + kColTile - 1) / kColTile);
    const dim3 block(kColTile, kColSegs);
    runmax_cols<<<grid, block, 0, stream>>>(vals, mask, out, prev, changed, H,
                                            W);
  }
  return static_cast<int>(cudaGetLastError());
}
