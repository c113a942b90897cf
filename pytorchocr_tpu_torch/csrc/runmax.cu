// Segmented run-max scan along one axis of an int32 (H, W) label map.
//
// Replaces the TPU kernel pytorchocr_tpu/ops/pallas_propagate.py:_runmax_kernel
// (launched by _runmax_band, wrapped by segmented_runmax_pallas). Along `axis`,
// every pixel of a maximal contiguous masked run gets max(0, max of the run);
// unmasked pixels get 0. Connected-component labelling alternates the two axes
// until nothing changes (pytorchocr_tpu_torch/ops/cc_label.py).
//
// What bounds it on an H100: bytes. Per pixel a pass must read 4 B of labels
// and 1 B of mask and write 4 B (axis 0 also reads 4 B of `prev` for the
// changed flag): 8.5 MB (12.3 MB) for a 736x1280 page, 2.5 us (3.7 us) at
// 3.35 TB/s. The arithmetic is a few integer max/selects a pixel. At page
// size a launch's fixed latency (the blocks' start, one round trip to L2,
// the stores) is of the order of the bound itself: at 184x320 a launch
// takes 3 us. So both axes read and write each pixel once, with all of a
// thread's loads in flight together.
//
// Axis 1, rows of up to 2,048 pixels (runmax_rows_held): one warp per row,
// the row staged through shared memory with coalesced 16-byte loads, then
// held in registers, 32 * K pixels a warp (K a lane); each lane scans its
// pixels, one segmented shuffle scan across the lanes gives each lane the
// runs that enter it from the left and from the right, and the row goes
// back out through shared memory with coalesced stores. Longer rows take
// the chunked loop of runmax_rows, which reads the row twice.
//
// Axis 0: a thread holds kSegRows rows of one column in registers; a block
// is kColW neighbouring columns (one 32-byte sector of labels a row) times
// up to kMaxSegs such segments, so a 736x1280 map is 160 blocks. A segment
// summarises itself (the max before its first boundary, the max after its
// last, whether it holds a boundary) into shared memory, and each segment
// finds the runs that enter it from above and below from the others'
// summaries. Maps taller than one block (kMaxSegs * kSegRows rows) are cut
// into row blocks: a first launch writes each block's summary to `scratch`,
// and the main launch reads the summaries of the blocks above and below.
// The changed flag of the fixpoint loop is fused into the axis-0 launch: one
// __syncthreads_or and one atomicOr a block, the flag zeroed by a memset in
// the same entry point.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kRowWarps = 8;   // rows (warps) per block for axis 1
constexpr int kRowChunks = 4;  // 32-wide chunks loaded together: loads in flight
constexpr int kColW = 8;       // columns per block for axis 0
constexpr int kSegRows = 16;   // rows a thread holds in registers for axis 0
constexpr int kMaxSegs = 1024 / kColW;  // segments per block: 2,048 rows
constexpr int kHeldWarps = 4;   // rows (warps) per block for axis 1, rows held
constexpr int kMaxLaneVals = 64;  // pixels a lane holds: rows up to 2,048 wide

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

// axis 1, rows wider than 32 * kMaxLaneVals: one warp per row, the row walked
// in chunks of 32 * kRowChunks with a carried running max; forward writes its
// result to `out`, backward reads the row again and combines.
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

// Segmented max-scan across the lanes of a warp towards lane 0: as
// warp_segmented_max, with "before" read as "after".
__device__ __forceinline__ void warp_segmented_max_down(int& x, int& f, int lane) {
#pragma unroll
  for (int s = 1; s < 32; s <<= 1) {
    int ox = __shfl_down_sync(kFull, x, s);
    int of = __shfl_down_sync(kFull, f, s);
    if (lane + s < 32) {
      if (!f) x = max(x, ox);
      f |= of;
    }
  }
}

// axis 1, rows of up to 32 * K pixels: one warp per row, every pixel read
// once and written once. The warp stages its row in shared memory with
// coalesced loads (16-byte vectors where the row is aligned); lane l then
// holds pixels [l * K, (l + 1) * K) in registers (stored at l * (K + 1) + k:
// K + 1 is odd, so the lanes' reads hit 32 different banks), scans them,
// exchanges one summary per lane with warp shuffles (the runs that enter
// from the left and from the right), finishes its pixels and writes them
// back through shared memory with coalesced stores.
template <int K>
__global__ void __launch_bounds__(kHeldWarps * 32)
runmax_rows_held(const int* __restrict__ vals, const uint8_t* __restrict__ mask,
                 int* __restrict__ out, int H, int W) {
  static_assert(K % 4 == 0 && K <= kMaxLaneVals, "whole vectors, K + 1 odd, within the buffer");
  __shared__ int s_v[kHeldWarps][32 * (kMaxLaneVals + 1)];
  __shared__ __align__(16) uint8_t s_m[kHeldWarps][32 * kMaxLaneVals];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int row = blockIdx.x * kHeldWarps + wid;
  if (row >= H) return;  // whole warp leaves together; only warp barriers below
  int* sv = s_v[wid];
  uint8_t* sm = s_m[wid];
  const size_t off = static_cast<size_t>(row) * W;
  const int* v_row = vals + off;
  const uint8_t* m_row = mask + off;
  int* o_row = out + off;
  const bool vec = ((reinterpret_cast<uintptr_t>(v_row) | reinterpret_cast<uintptr_t>(o_row)) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(m_row) & 3) == 0;
  const int n4 = vec ? W / 4 : 0;  // 16-byte vectors; the rest one by one

  // all of a lane's loads are issued before its shared-memory stores
  int4 xs[K / 4];
  uint32_t ms[K / 4];
#pragma unroll
  for (int t = 0; t < K / 4; ++t) {
    const int q = lane + 32 * t;
    if (q < n4) {
      xs[t] = reinterpret_cast<const int4*>(v_row)[q];
      ms[t] = reinterpret_cast<const uint32_t*>(m_row)[q];
    }
  }
#pragma unroll
  for (int t = 0; t < K / 4; ++t) {
    const int q = lane + 32 * t;
    if (q < n4) {
      const int i = 4 * q;
      sv[i + i / K] = xs[t].x;
      sv[i + 1 + (i + 1) / K] = xs[t].y;
      sv[i + 2 + (i + 2) / K] = xs[t].z;
      sv[i + 3 + (i + 3) / K] = xs[t].w;
      reinterpret_cast<uint32_t*>(sm)[q] = ms[t];
    }
  }
  for (int i = 4 * n4 + lane; i < W; i += 32) {
    sv[i + i / K] = v_row[i];
    sm[i] = m_row[i];
  }
  __syncwarp();

  const int base = lane * K;
  int v[K];
  unsigned long long m = 0;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    v[k] = 0;
    if (base + k < W && sm[base + k]) {
      v[k] = sv[base + k + lane];
      m |= 1ull << k;
    }
  }
  int run = 0, head = 0, hasb = 0;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if ((m >> k) & 1ull) {
      run = max(run, v[k]);
    } else {
      if (!hasb) head = run;
      hasb = 1;
      run = 0;
    }
  }
  if (!hasb) head = run;
  int x = run, f = hasb;
  warp_segmented_max(x, f, lane);  // the run reaching the end of lane l
  int cf = __shfl_up_sync(kFull, x, 1);
  if (lane == 0) cf = 0;
  int y = head, g = hasb;
  warp_segmented_max_down(y, g, lane);  // the run reaching the start of lane l
  int cb = __shfl_down_sync(kFull, y, 1);
  if (lane == 31) cb = 0;

  run = cf;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if ((m >> k) & 1ull) {
      run = max(run, v[k]);
      v[k] = run;
    } else {
      run = 0;
    }
  }
  int best = cb;
#pragma unroll
  for (int k = K - 1; k >= 0; --k) {
    if ((m >> k) & 1ull) {
      best = max(best, v[k]);
      v[k] = best;
    } else {
      best = 0;
      v[k] = 0;
    }
  }
  __syncwarp();  // every lane has read its pixels before any overwrites
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (base + k < W) sv[base + k + lane] = v[k];
  }
  __syncwarp();

#pragma unroll
  for (int t = 0; t < K / 4; ++t) {
    const int q = lane + 32 * t;
    if (q >= n4) break;
    const int i = 4 * q;
    reinterpret_cast<int4*>(o_row)[q] =
        make_int4(sv[i + i / K], sv[i + 1 + (i + 1) / K], sv[i + 2 + (i + 2) / K],
                  sv[i + 3 + (i + 3) / K]);
  }
  for (int i = 4 * n4 + lane; i < W; i += 32) o_row[i] = sv[i + i / K];
}

// axis 0. Block (bx, by) owns columns [bx * kColW, +kColW) and rows
// [by * S * kSegRows, +S * kSegRows), S = blockDim.y; thread (tx, ty) holds
// kSegRows rows of one column. Rows past H are boundaries. `scratch` holds
// three gridDim.y x W planes (head, tail, has-boundary) of block summaries:
// kSummary launches write them, the main launch reads them (only where
// gridDim.y > 1).
template <bool kSummary>
__global__ void __launch_bounds__(1024)
runmax_cols(const int* __restrict__ vals, const uint8_t* __restrict__ mask,
            int* __restrict__ out, const int* __restrict__ prev,
            int* __restrict__ changed, int* __restrict__ scratch, int H, int W) {
  __shared__ int s_head[kMaxSegs][kColW];
  __shared__ int s_tail[kMaxSegs][kColW];
  __shared__ int s_hasb[kMaxSegs][kColW];
  const int tx = threadIdx.x, ty = threadIdx.y, S = blockDim.y;
  const int by = blockIdx.y, nby = gridDim.y;
  const int c = blockIdx.x * kColW + tx;
  const bool live = c < W;
  const int r0 = (by * S + ty) * kSegRows;

  int v[kSegRows], p[kSegRows];  // p: prev, loaded with the rest
  unsigned m = 0;
#pragma unroll
  for (int k = 0; k < kSegRows; ++k) {
    v[k] = 0;
    p[k] = 0;
    if (live && r0 + k < H) {
      const size_t i = static_cast<size_t>(r0 + k) * W + c;
      const int x = vals[i];
      if (!kSummary && prev != nullptr) p[k] = prev[i];
      if (mask[i]) {
        v[k] = x;
        m |= 1u << k;
      }
    }
  }

  // this segment's summary
  int run = 0, head = 0;
  bool hasb = false;
#pragma unroll
  for (int k = 0; k < kSegRows; ++k) {
    if ((m >> k) & 1u) {
      run = max(run, v[k]);
    } else {
      if (!hasb) head = run;
      hasb = true;
      run = 0;
    }
  }
  if (!hasb) head = run;
  s_head[ty][tx] = head;
  s_tail[ty][tx] = run;
  s_hasb[ty][tx] = hasb;
  __syncthreads();

  const size_t plane = static_cast<size_t>(nby) * W;
  if (kSummary) {
    if (ty == 0 && live) {  // the block's summary, from its segments'
      int h = 0, t = 0, b = 0;
      for (int k = 0; k < S; ++k) {
        h = max(h, s_head[k][tx]);
        if (s_hasb[k][tx]) { b = 1; break; }
      }
      for (int k = S - 1; k >= 0; --k) {
        t = max(t, s_tail[k][tx]);
        if (s_hasb[k][tx]) break;
      }
      const size_t j = static_cast<size_t>(by) * W + c;
      scratch[j] = h;
      scratch[plane + j] = t;
      scratch[2 * plane + j] = b;
    }
    return;
  }

  // the runs entering from above (cf) and from below (cb): other segments of
  // this block, then, if no boundary stopped them, the blocks above / below
  int cf = 0, cb = 0;
  bool open = true;
  for (int k = ty - 1; k >= 0; --k) {
    cf = max(cf, s_tail[k][tx]);
    if (s_hasb[k][tx]) { open = false; break; }
  }
  if (open && live) {
    for (int b = by - 1; b >= 0; --b) {
      const size_t j = static_cast<size_t>(b) * W + c;
      cf = max(cf, scratch[plane + j]);
      if (scratch[2 * plane + j]) break;
    }
  }
  open = true;
  for (int k = ty + 1; k < S; ++k) {
    cb = max(cb, s_head[k][tx]);
    if (s_hasb[k][tx]) { open = false; break; }
  }
  if (open && live) {
    for (int b = by + 1; b < nby; ++b) {
      const size_t j = static_cast<size_t>(b) * W + c;
      cb = max(cb, scratch[j]);
      if (scratch[2 * plane + j]) break;
    }
  }

  // forward max from the top of each run (cf continues the top run), then
  // backward: each pixel takes the forward max at its run's bottom
  run = cf;
#pragma unroll
  for (int k = 0; k < kSegRows; ++k) {
    if ((m >> k) & 1u) {
      run = max(run, v[k]);
      v[k] = run;
    } else {
      run = 0;
    }
  }
  int best = cb;
  bool diff = false;
#pragma unroll
  for (int k = kSegRows - 1; k >= 0; --k) {
    int res = 0;
    if ((m >> k) & 1u) {
      best = max(best, v[k]);
      res = best;
    } else {
      best = 0;
    }
    if (live && r0 + k < H) {
      const size_t i = static_cast<size_t>(r0 + k) * W + c;
      out[i] = res;
      if (prev != nullptr && res != p[k]) diff = true;
    }
  }
  if (changed != nullptr && __syncthreads_or(diff) && tx == 0 && ty == 0) {
    atomicOr(changed, 1);
  }
}

}  // namespace

// C entry point, bound with ctypes by pytorchocr_tpu_torch/ops/runmax.py.
// Launches on `stream`, does not synchronise, allocates nothing. `prev` and
// `changed` may be null; given (axis 0 only: the fixpoint loop reads the flag
// once per alternation, after its column pass), *changed is zeroed here and
// set to 1 if any output differs from prev. Axis 0 on a map of more than
// kMaxSegs * kSegRows = 2,048 rows (ops/runmax.py: BLOCK_ROWS) needs `scratch`
// of 3 * ceil(H / 2048) * W ints (`scratch_ints` says how many it holds).
// Returns cudaGetLastError(), or cudaErrorInvalidValue for a flag asked of
// axis 1 or scratch too small.
extern "C" int runmax_launch(const int* vals, const uint8_t* mask, int* out,
                             const int* prev, int* changed, int* scratch,
                             long long scratch_ints, int H, int W, int axis,
                             cudaStream_t stream) {
  if (H <= 0 || W <= 0) return 0;
  if (axis == 1) {
    if (prev != nullptr || changed != nullptr) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const dim3 held((H + kHeldWarps - 1) / kHeldWarps), threads(kHeldWarps * 32);
    if (W <= 32 * 4) {
      runmax_rows_held<4><<<held, threads, 0, stream>>>(vals, mask, out, H, W);
    } else if (W <= 32 * 8) {
      runmax_rows_held<8><<<held, threads, 0, stream>>>(vals, mask, out, H, W);
    } else if (W <= 32 * 16) {
      runmax_rows_held<16><<<held, threads, 0, stream>>>(vals, mask, out, H, W);
    } else if (W <= 32 * 24) {
      runmax_rows_held<24><<<held, threads, 0, stream>>>(vals, mask, out, H, W);
    } else if (W <= 32 * 40) {
      runmax_rows_held<40><<<held, threads, 0, stream>>>(vals, mask, out, H, W);
    } else if (W <= 32 * kMaxLaneVals) {
      runmax_rows_held<kMaxLaneVals><<<held, threads, 0, stream>>>(vals, mask, out, H, W);
    } else {
      const dim3 grid((H + kRowWarps - 1) / kRowWarps);
      runmax_rows<<<grid, kRowWarps * 32, 0, stream>>>(vals, mask, out, H, W);
    }
    return static_cast<int>(cudaGetLastError());
  }
  if (changed != nullptr) {
    const cudaError_t err = cudaMemsetAsync(changed, 0, sizeof(int), stream);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // rows cut into nby blocks of S segments, as even as the segment size allows
  const int segs = (H + kSegRows - 1) / kSegRows;
  const int nby = (segs + kMaxSegs - 1) / kMaxSegs;
  const int S = (segs + nby - 1) / nby;
  const dim3 grid((W + kColW - 1) / kColW, nby);
  const dim3 block(kColW, S);
  if (nby > 1) {
    if (scratch == nullptr || scratch_ints < 3LL * nby * W) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    runmax_cols<true><<<grid, block, 0, stream>>>(vals, mask, out, prev, changed,
                                                  scratch, H, W);
  }
  runmax_cols<false><<<grid, block, 0, stream>>>(vals, mask, out, prev, changed,
                                                 scratch, H, W);
  return static_cast<int>(cudaGetLastError());
}
