// int8 convolution, exact int32 sum, float32 dequant, float32 or bf16 output
// — for Hopper (sm_90a).
//
// Replaces the int8 conv that XLA lowers for the JAX package
// (pytorchocr_tpu/ops/quant.py:252-255, lax.conv_general_dilated(xq, wq,
// preferred_element_type=int32), the f32 dequant after it and the cast to
// the compute dtype); no Pallas kernel. PyTorch has no int8 convolution on
// CUDA.
//
//   y[m, oc] = out(__fadd_rn(__fmul_rn(__int2float_rn(sum_k A[m, k] * B[oc, k]), scale[oc]), bias[oc]))
//
// with out() the identity (float32) or __float2bfloat16_rn (bf16), as an
// implicit GEMM: M = N*Ho*Wo output pixels, N = Cout, K = kh*kw*Cin in (kh,
// kw, cin) order. x is int8 NHWC (a channels_last NCHW tensor), w int8
// packed (Cout, kh, kw, Cin/groups), y NHWC. The multiply and the add are
// separate roundings (the intrinsics are never contracted into an FMA), so y
// equals the plain version (ops/int8_conv.py:int8_conv_ref) bit for bit; any
// order of the integer sums gives the same int32.
//
// What bounds it (PERF.md, the per-shape table): at the DB-ResNet18 shapes
// K is 147..4608. The output is most of every shape's bytes (the stem
// writes 60 M outputs from 2.8 MB of input), so most shapes are bound by
// bytes, by the output; the 3x3 convs of layers 3-4 by int8 operations.
// The first port wrote float32 always, through 4 warps of mma.sync fed by
// a two-stage cp.async loop, latency-bound at 10-23% of the bound. Here:
//
//  * Tensor cores through wgmma.mma_async m64nNk32 s8 (N = 64 for Cout <=
//    64, else 128), one or two consumer warpgroups of 64 output rows each,
//    int32 accumulators in registers. Both operands are K-major in shared
//    memory, 64 bytes of K a row, 64-byte swizzle (the only layout wgmma
//    takes for 8-bit types); the descriptor steps 32 bytes of K a wgmma.
//  * A ring of 4-8 shared-memory stages (as many as 96 KB holds, 64 KB
//    where three blocks share an SM) with full and empty mbarriers,
//    filled by producer warps while the consumers compute:
//    - B (the weights, a plain (Cout, K) matrix) by TMA, 64-byte swizzle;
//      its tensor map is encoded once per weight buffer and cached;
//    - A of a 1x1 stride-1 conv (the FPN laterals: a plain (M, Cin) matrix)
//      by TMA too (mode 0); the tile's rows past M and K past Cin read zero;
//    - A of any other conv with Cin % 16 == 0 (mode 1) by 16-byte cp.async
//      gathers written into the swizzled layout by hand, zero-filled
//      outside the image and past K, by two or four producer warps (the
//      gathers are bound by their instruction count); each producer
//      thread keeps all but two stages of the ring in flight and, once a
//      stage's copies land, fences them into the async proxy
//      (fence.proxy.async) before it arrives on the stage's barrier;
//    - the 3-channel stem (K = 147) and any Cin % 16 != 0 by four producer
//      warps into 64-row tiles, K zero-padded in shared memory (taps of 3
//      channels are 3-byte aligned, so no 16-byte copy reaches them): A
//      built byte by byte from the tile's input patch (kh input rows of
//      the columns its pixels reach: 5.5 KB for the stem's 128), staged
//      once in shared memory by coalesced loads, where the tile's pixels
//      lie in one output row or run on into the next (a patch segment for
//      each; mode 3: the stem, on landscape pages of 640-pixel output rows
//      and portrait pages of 368, no multiple of the tile); else (output rows
//      narrower than the tile, or a patch past 16 KB) gathered byte by byte
//      from device memory into 64-row tiles (mode 2); B by byte loads.
//  * Epilogue: the dequant as above, written in the output dtype straight
//    from the accumulators into shared memory (the ring, free once every
//    consumer has finished its last wgmma), then 16-byte coalesced stores.
//    bf16 output halves the output bytes and replaces the separate cast.
//  * Filling the card: grid (Cout tiles, M tiles), Cout fastest, so the
//    blocks that read one A tile run together; 128-row tiles (two consumer
//    warpgroups) where they give 2 waves of the SMs or more, else 64-row
//    tiles (layers 3-4); two or three blocks an SM, so one block's
//    epilogue overlaps another's loads.
// Grouped convs with one input channel a group (depthwise, and channel
// multipliers Cout = m Cin: every grouped conv of the MobileNetV3 and
// ShuffleNetV2 detectors) take int8_dwconv, a stencil kernel with its own
// note below. The rest of the grouped convs (Cg > 1, as RepVGG's
// groups_map, which no config names; depthwise windows past 5x5, strides
// past 2 or unequal, multipliers past 64) keep int8_conv_direct, one
// thread an output. What the GEMM leaves out (a persistent schedule,
// split-K, a fused BN/activation/requant epilogue): PERF.md Open questions.

#include <cuda.h>  // CUtensorMap and its enums; cuTensorMapEncodeTiled comes by entry point
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>
#include <cstring>
#include <initializer_list>
#include <map>
#include <mutex>
#include <tuple>

namespace {

constexpr int BK = 64;   // bytes of K a stage: one 64-byte swizzled row
constexpr int ROW = 64;  // output rows of a consumer warpgroup
constexpr int PATCH_BYTES = 16384;  // mode 3: the input patch of a tile

struct Shape {
  int N, H, W, Cin, Cout, kh, kw, Ho, Wo, sh, sw, ph, pw, dh, dw, groups;
  int Cg, K, M;
};

// ---------------------------------------------------------------- PTX
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)  // 0: write 16 zero bytes, read nothing
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// what the generic proxy wrote to shared memory becomes visible to the
// async proxy (wgmma's operand reads), and the other way round
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int PENDING>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(PENDING) : "memory");
}

// wgmma shared-memory descriptor of a K-major tile of 64-byte rows, 64-byte
// swizzle: start address >> 4 (bits 0-13), leading offset 1 (unused by a
// swizzled K-major layout, bits 16-29), stride between 8-row groups 512
// bytes >> 4 (bits 32-45), layout 64B (2, bits 62-63). The tile starts on
// a 512-byte boundary, so the base offset (bits 49-51) is 0; the next 32
// bytes of K are the same descriptor + 2.
__device__ __forceinline__ uint64_t smem_desc(const void* tile) {
  return (static_cast<uint64_t>(smem_u32(tile) & 0x3FFFF) >> 4) | (uint64_t(1) << 16) |
         (uint64_t(512 >> 4) << 32) | (uint64_t(2) << 62);
}

// byte offset of 16-byte chunk `c` (0..3) of row `r` in a tile of 64-byte
// rows with the 64-byte swizzle (address bits 4-5 ^= bits 7-8), as TMA
// writes it and wgmma reads it
__device__ __forceinline__ uint32_t swz64(int r, int c) {
  return static_cast<uint32_t>(r * 64 + ((c ^ ((r >> 1) & 3)) << 4));
}

// ---------------------------------------------------------------- wgmma
// D (64 x 64, s32, in registers) += A (64 x 32 s8, descriptor) * B (64 x 32 s8, descriptor)^T
__device__ __forceinline__ void wgmma_n64(int* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// D (64 x 128, s32, in registers) += A (64 x 32 s8, descriptor) * B (128 x 32 s8, descriptor)^T
__device__ __forceinline__ void wgmma_n128(int* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

template <int BN>
__device__ __forceinline__ void wgmma_k32(int* d, uint64_t da, uint64_t db);
template <>
__device__ __forceinline__ void wgmma_k32<64>(int* d, uint64_t da, uint64_t db) {
  wgmma_n64(d, da, db);
}
template <>
__device__ __forceinline__ void wgmma_k32<128>(int* d, uint64_t da, uint64_t db) {
  wgmma_n128(d, da, db);
}

// ---------------------------------------------------------------- epilogue
__device__ __forceinline__ float dequant(int acc, float scale, float bias, bool has_bias) {
  const float v = __fmul_rn(__int2float_rn(acc), scale);
  return has_bias ? __fadd_rn(v, bias) : v;
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) =
      __halves2bfloat162(__float2bfloat16_rn(a), __float2bfloat16_rn(b));
}
__device__ __forceinline__ void store1(float* p, float a) { *p = a; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float a) { *p = __float2bfloat16_rn(a); }
__device__ __forceinline__ void store4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float a, float b, float c, float d) {
  const __nv_bfloat162 lo = __halves2bfloat162(__float2bfloat16_rn(a), __float2bfloat16_rn(b));
  const __nv_bfloat162 hi = __halves2bfloat162(__float2bfloat16_rn(c), __float2bfloat16_rn(d));
  uint2 v;
  v.x = *reinterpret_cast<const uint32_t*>(&lo);
  v.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = v;
}

// ---------------------------------------------------------------- the GEMM
// The output pixel of GEMM row m: the element offset of its image in x and
// the input position of tap (0, 0); rows past M never pass the bounds test.
struct Row {
  int base, hi0, wi0;
};

__device__ __forceinline__ Row row_of(const Shape& s, int m) {
  Row r{0, -(1 << 28), 0};
  if (m < s.M) {
    const int n = m / (s.Ho * s.Wo), rem = m - n * s.Ho * s.Wo;
    const int ho = rem / s.Wo, wo = rem - ho * s.Wo;
    r.base = n * s.H * s.W * s.Cin;
    r.hi0 = ho * s.sh - s.ph;
    r.wi0 = wo * s.sw - s.pw;
  }
  return r;
}

// MODE 0: A and B by TMA (1x1 stride-1, Cin % 16 == 0); 1: A by 16-byte
// cp.async gathers, B by TMA (Cin % 16 == 0); 2: A and B by byte loads; 3:
// as 2, but A built from the tile's input patch, staged once in shared
// memory (a tile of 64 or 128 pixels of one output row, or of the end of
// one and the start of the next).
template <int NC, int BN, int MODE, typename OutT>
struct Cfg {
  static constexpr int BM = NC * ROW;
  // producer warps: one starts mode 0's TMA copies; the gathers of modes
  // 1-3 are bound by their instruction count, so more warps share them
  static constexpr int PW = MODE == 0 ? 1 : (MODE == 1 && BN == 128) ? 2 : 4;
  static constexpr int THREADS = NC * 128 + PW * 32;
  static constexpr int A_BYTES = BM * BK, B_BYTES = BN * BK;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  // blocks an SM: registers (65,536) over threads; 64 accumulators a thread
  // and the byte loads of modes 2-3 need more than 65,536 / (2 x 256)
  static constexpr int MIN_BLOCKS = (MODE >= 2 && BN == 128) ? 1 : NC == 1 ? 3 : 2;
  static constexpr int PATCH = MODE == 3 ? PATCH_BYTES : 0;
  static_assert(MODE != 2 || NC == 1, "mode 2 takes 64-row tiles");
  // the ring: 4 to 8 stages, as many as 96 KB (two blocks an SM) or 64 KB
  // (three), less the patch, holds
  static constexpr int RING_BUDGET = (MIN_BLOCKS == 3 ? 64 : 96) * 1024 - PATCH;
  static constexpr int STAGES = RING_BUDGET / STAGE_BYTES < 4   ? 4
                                : RING_BUDGET / STAGE_BYTES > 8 ? 8
                                                                : RING_BUDGET / STAGE_BYTES;
  static constexpr int LAG = STAGES - 2;  // mode 1: stages a producer thread keeps in flight
  static constexpr int RING = STAGES * STAGE_BYTES;
  static constexpr int PITCH = (BN + 8) * static_cast<int>(sizeof(OutT));  // epilogue row, bytes
  static constexpr int EPI = BM * PITCH;
  static constexpr int DATA = RING > EPI ? RING : EPI;
  // + the patch, the barriers, and 1024 bytes to align the ring
  static constexpr int SMEM = DATA + PATCH + 2 * STAGES * 8 + 1024;
  // arrivals that complete a full barrier: mode 0 the TMA thread; mode 1
  // the producer threads after their copies land, and thread 0's expect_tx
  // for B; modes 2-3 every producer thread after its stores
  static constexpr int FULL_COUNT = MODE == 0 ? 1 : MODE == 1 ? PW * 32 + 1 : PW * 32;
};

template <int NC, int BN, int MODE, typename OutT>
__global__ void __launch_bounds__((Cfg<NC, BN, MODE, OutT>::THREADS),
                                  (Cfg<NC, BN, MODE, OutT>::MIN_BLOCKS))
    int8_conv_wgmma(const __grid_constant__ CUtensorMap map_a,
                    const __grid_constant__ CUtensorMap map_b, const int8_t* __restrict__ x,
                    const int8_t* __restrict__ w, const float* __restrict__ scale,
                    const float* __restrict__ bias, OutT* __restrict__ y, Shape s) {
  using C = Cfg<NC, BN, MODE, OutT>;
  constexpr int STAGES = C::STAGES, LAG = C::LAG;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* patch = smem + C::DATA;  // mode 3
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::DATA + C::PATCH);
  uint64_t* empty = full + STAGES;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // Cout tiles fastest: the blocks that read one A tile run together
  const int n_tiles = (s.Cout + BN - 1) / BN;
  const int n0 = (blockIdx.x % n_tiles) * BN, m0 = (blockIdx.x / n_tiles) * C::BM;
  const int KT = (s.K + BK - 1) / BK;

  if (tid == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&full[i], C::FULL_COUNT);
      mbar_init(&empty[i], NC * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= NC * 4) {  // ------------------------------------ producer
    const int pt = tid - NC * 128;
    if constexpr (MODE == 0) {
      if (pt == 0) {
        for (int kt = 0; kt < KT; ++kt) {
          const int st = kt % STAGES;
          mbar_wait(&empty[st], ((kt / STAGES) & 1) ^ 1);
          uint8_t* stage = smem + st * C::STAGE_BYTES;
          mbar_arrive_expect_tx(&full[st], C::STAGE_BYTES);
          tma_load_2d(stage, &map_a, &full[st], kt * BK, m0);
          tma_load_2d(stage + C::A_BYTES, &map_b, &full[st], kt * BK, n0);
        }
      }
    } else if constexpr (MODE == 1) {
      // thread: the 16-byte chunk j = pt % 4 of A rows pt / 4 + 8 PW i, so
      // one tap (r, q) and channel c a stage, stepped along K without
      // divisions (Cin % 16 == 0: a chunk is 16 channels of one tap)
      constexpr int RPT = C::BM / (C::PW * 8), STEP = C::PW * 8;
      const int j = pt & 3, r0 = pt >> 2;
      Row rows[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) rows[i] = row_of(s, m0 + r0 + STEP * i);
      int k = 16 * j, c = k % s.Cin, q = (k / s.Cin) % s.kw, r = k / s.Cin / s.kw;
      for (int kt = 0; kt < KT; ++kt) {
        const int st = kt % STAGES;
        mbar_wait(&empty[st], ((kt / STAGES) & 1) ^ 1);
        uint8_t* stage = smem + st * C::STAGE_BYTES;
        if (pt == 0) {
          mbar_arrive_expect_tx(&full[st], C::B_BYTES);
          tma_load_2d(stage + C::A_BYTES, &map_b, &full[st], kt * BK, n0);
        }
        const uint32_t a_s = smem_u32(stage);
        const int dr = r * s.dh, dq = q * s.dw;
        const bool kin = k < s.K;
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          const int hi = rows[i].hi0 + dr, wi = rows[i].wi0 + dq;
          const bool ok = kin && static_cast<unsigned>(hi) < static_cast<unsigned>(s.H) &&
                          static_cast<unsigned>(wi) < static_cast<unsigned>(s.W);
          const int8_t* src =
              ok ? x + rows[i].base + (static_cast<size_t>(hi) * s.W + wi) * s.Cin + c : x;
          cp_async16(a_s + swz64(r0 + STEP * i, j), src, ok);
        }
        k += BK;
        for (c += BK; c >= s.Cin; c -= s.Cin)
          if (++q == s.kw) {
            q = 0;
            ++r;
          }
        cp_async_commit();
        if (kt >= LAG) {
          cp_async_wait<LAG>();  // stage kt - LAG's copies have landed
          fence_proxy_async();
          mbar_arrive(&full[(kt - LAG) % STAGES]);
        }
      }
      cp_async_wait<0>();
      fence_proxy_async();
      for (int kt = KT > LAG ? KT - LAG : 0; kt < KT; ++kt) mbar_arrive(&full[kt % STAGES]);
    } else {
      // thread: 16 bytes of K (chunk pt & 3) of A rows (pt >> 2) + 32 i and
      // of B rows (pt >> 2) + 32 i, byte by byte, zero outside
      const int cc = pt & 3, r0 = pt >> 2;
      Row rows[C::BM / 32];
      int span = 0;          // mode 3: bytes a patch row
      int pofs[C::BM / 32];  // mode 3: where row r0 + 32 i's pixel starts in the patch
      if constexpr (MODE == 2) {
#pragma unroll
        for (int i = 0; i < C::BM / 32; ++i) rows[i] = row_of(s, m0 + r0 + 32 * i);
      } else {
        // the patch: for each output row the tile's pixels lie in (one, or
        // two where the tile runs past a row's end: segment 1 from pixel
        // `split`, on the next row or image), kh input rows of the columns
        // its pixels reach, zero outside the image; coalesced byte loads,
        // once a tile, eight in flight a thread. Byte b of the patch is byte
        // `off` of patch row `r` (b = r span + off; rows kh.. are segment
        // 1's), stepped without divisions; a row's bytes inside the image
        // are [lo, hi_b).
        const Row t0 = row_of(s, m0);
        const int wo0 = (m0 % (s.Ho * s.Wo)) % s.Wo;
        const int split = s.Wo - wo0 < C::BM ? s.Wo - wo0 : C::BM;
        const Row t1 = row_of(s, m0 + split);  // past M: reads zeros
        span = ((C::BM - 1) * s.sw + (s.kw - 1) * s.dw + 1) * s.Cin;
        const int seg = s.kh * span, total = (split < C::BM ? 2 : 1) * seg;
#pragma unroll
        for (int i = 0; i < C::BM / 32; ++i) {
          const int p = r0 + 32 * i;
          pofs[i] = p < split ? p * s.sw * s.Cin : seg + (p - split) * s.sw * s.Cin;
        }
        const int lo0 = (t0.wi0 < 0 ? -t0.wi0 : 0) * s.Cin, hb0 = (s.W - t0.wi0) * s.Cin;
        const int lo1 = (t1.wi0 < 0 ? -t1.wi0 : 0) * s.Cin, hb1 = (s.W - t1.wi0) * s.Cin;
        constexpr int U = 8, NP = C::PW * 32;
        int r = pt / span, off = pt - r * span;
        for (int b0 = pt; b0 < total; b0 += U * NP) {
          uint8_t v[U];
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const bool s1 = r >= s.kh;
            const int hi = s1 ? t1.hi0 + (r - s.kh) * s.dh : t0.hi0 + r * s.dh;
            const int base = s1 ? t1.base : t0.base, wi0 = s1 ? t1.wi0 : t0.wi0;
            const bool ok = b0 + u * NP < total &&
                            static_cast<unsigned>(hi) < static_cast<unsigned>(s.H) &&
                            off >= (s1 ? lo1 : lo0) && off < (s1 ? hb1 : hb0);
            const uint8_t byte = static_cast<uint8_t>(
                x[ok ? base + (static_cast<size_t>(hi) * s.W + wi0) * s.Cin + off : 0]);
            v[u] = ok ? byte : uint8_t(0);
            for (off += NP; off >= span; off -= span) ++r;
          }
#pragma unroll
          for (int u = 0; u < U; ++u)
            if (b0 + u * NP < total) patch[b0 + u * NP] = v[u];
        }
        named_barrier(2, NP);
      }
      for (int kt = 0; kt < KT; ++kt) {
        const int st = kt % STAGES;
        mbar_wait(&empty[st], ((kt / STAGES) & 1) ^ 1);
        uint8_t* stage = smem + st * C::STAGE_BYTES;
        const int k0 = kt * BK + 16 * cc;
        int rs = k0 / s.Cin, c = k0 - rs * s.Cin;
        int r = rs / s.kw, q = rs - r * s.kw;
        uint32_t a[C::BM / 32][4];
#pragma unroll
        for (int i = 0; i < C::BM / 32; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) a[i][e] = 0;
#pragma unroll
        for (int e = 0; e < 16; ++e) {
          const bool kin = k0 + e < s.K;
          const int dr = r * s.dh, dq = q * s.dw;
#pragma unroll
          for (int i = 0; i < C::BM / 32; ++i) {
            // a load from a valid address whatever the bounds, then a select:
            // no branch, so the compiler keeps many loads in flight
            uint32_t v;
            bool ok;
            if constexpr (MODE == 2) {
              const int hi = rows[i].hi0 + dr, wi = rows[i].wi0 + dq;
              ok = kin && static_cast<unsigned>(hi) < static_cast<unsigned>(s.H) &&
                   static_cast<unsigned>(wi) < static_cast<unsigned>(s.W);
              v = static_cast<uint8_t>(
                  x[ok ? rows[i].base + (static_cast<size_t>(hi) * s.W + wi) * s.Cin + c : 0]);
            } else {  // pixel p of the tile reads its segment's patch row r at column p sw + q dw
              ok = kin;
              v = patch[ok ? pofs[i] + r * span + dq * s.Cin + c : 0];
            }
            a[i][e >> 2] |= (ok ? v : 0u) << (8 * (e & 3));
          }
          if (++c == s.Cin) {
            c = 0;
            if (++q == s.kw) {
              q = 0;
              ++r;
            }
          }
        }
#pragma unroll
        for (int i = 0; i < C::BM / 32; ++i)
          *reinterpret_cast<uint4*>(stage + swz64(r0 + 32 * i, cc)) =
              make_uint4(a[i][0], a[i][1], a[i][2], a[i][3]);
#pragma unroll
        for (int i = 0; i < BN / 32; ++i) {
          const int oc = n0 + r0 + 32 * i;
          uint32_t b[4] = {0, 0, 0, 0};
#pragma unroll
          for (int e = 0; e < 16; ++e) {
            const bool ok = oc < s.Cout && k0 + e < s.K;
            const uint32_t v =
                static_cast<uint8_t>(w[ok ? static_cast<size_t>(oc) * s.K + k0 + e : 0]);
            b[e >> 2] |= (ok ? v : 0u) << (8 * (e & 3));
          }
          *reinterpret_cast<uint4*>(stage + C::A_BYTES + swz64(r0 + 32 * i, cc)) =
              make_uint4(b[0], b[1], b[2], b[3]);
        }
        fence_proxy_async();
        mbar_arrive(&full[st]);
      }
    }
    return;
  }

  // -------------------------------------------------------------- consumers
  const int wg = warp >> 2;  // this warpgroup's 64 rows: m0 + 64 wg ...
  int acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
  for (int kt = 0; kt < KT; ++kt) {
    const int st = kt % STAGES;
    mbar_wait(&full[st], (kt / STAGES) & 1);
    const uint8_t* stage = smem + st * C::STAGE_BYTES;
    const uint64_t da = smem_desc(stage + wg * ROW * BK), db = smem_desc(stage + C::A_BYTES);
    wgmma_fence();
    wgmma_k32<BN>(acc, da, db);
    wgmma_k32<BN>(acc, da + 2, db + 2);  // the next 32 bytes of K
    wgmma_commit();
    wgmma_wait<1>();  // the previous stage's products are done: release it
    if (kt > 0) mbar_arrive(&empty[(kt - 1) % STAGES]);
  }
  wgmma_wait<0>();

  // epilogue: dequantized rows in shared memory (the ring, once every
  // consumer is done with it), then 16-byte stores
  fence_proxy_async();
  named_barrier(1, NC * 128);
  constexpr int EP = C::PITCH / static_cast<int>(sizeof(OutT));  // elements an epilogue row
  OutT* E = reinterpret_cast<OutT*>(smem) + wg * ROW * EP;
  const int t = tid & 127;
  const bool has_bias = bias != nullptr;
  {
    // accumulator j*4 + 2h + e: row 16 (t / 32) + lane / 4 + 8 h, column 8 j + 2 (lane % 4) + e
    const int rr = (t >> 5) * 16 + (lane >> 2);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = 8 * j + 2 * (lane & 3), oc = n0 + col;
      const float s0 = oc < s.Cout ? scale[oc] : 0.0f, s1 = oc + 1 < s.Cout ? scale[oc + 1] : 0.0f;
      const float b0 = has_bias && oc < s.Cout ? bias[oc] : 0.0f;
      const float b1 = has_bias && oc + 1 < s.Cout ? bias[oc + 1] : 0.0f;
#pragma unroll
      for (int h = 0; h < 2; ++h)
        store2(E + (rr + 8 * h) * EP + col, dequant(acc[4 * j + 2 * h], s0, b0, has_bias),
               dequant(acc[4 * j + 2 * h + 1], s1, b1, has_bias));
    }
  }
  named_barrier(1, NC * 128);
  const int mw = m0 + wg * ROW;
  constexpr int VEC = 16 / static_cast<int>(sizeof(OutT));  // elements a 16-byte store
  if (s.Cout % VEC == 0) {
    constexpr int CPR = BN / VEC;
    for (int i = t; i < ROW * CPR; i += 128) {
      const int row = i / CPR, oc = n0 + (i % CPR) * VEC;
      if (mw + row < s.M && oc < s.Cout)
        *reinterpret_cast<uint4*>(y + static_cast<size_t>(mw + row) * s.Cout + oc) =
            *reinterpret_cast<const uint4*>(E + row * EP + (i % CPR) * VEC);
    }
  } else {
    for (int i = t; i < ROW * BN; i += 128) {
      const int row = i / BN, oc = n0 + i % BN;
      if (mw + row < s.M && oc < s.Cout)
        y[static_cast<size_t>(mw + row) * s.Cout + oc] = E[row * EP + i % BN];
    }
  }
}

// Grouped convs that int8_dwconv does not take (route() below): one thread
// an output element.
template <typename OutT>
__global__ void int8_conv_direct(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                                 const float* __restrict__ scale, const float* __restrict__ bias,
                                 OutT* __restrict__ y, Shape s) {
  const size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<size_t>(s.M) * s.Cout) return;
  const int oc = static_cast<int>(idx % s.Cout);
  const int m = static_cast<int>(idx / s.Cout);
  const Row row = row_of(s, m);
  const int c0 = (oc / (s.Cout / s.groups)) * s.Cg;
  int acc = 0;
  for (int r = 0; r < s.kh; ++r) {
    const int hi = row.hi0 + r * s.dh;
    if (hi < 0 || hi >= s.H) continue;
    for (int q = 0; q < s.kw; ++q) {
      const int wi = row.wi0 + q * s.dw;
      if (wi < 0 || wi >= s.W) continue;
      const int8_t* xp = x + row.base + (static_cast<size_t>(hi) * s.W + wi) * s.Cin + c0;
      const int8_t* wp = w + ((static_cast<size_t>(oc) * s.kh + r) * s.kw + q) * s.Cg;
      for (int c = 0; c < s.Cg; ++c) acc += int(xp[c]) * int(wp[c]);
    }
  }
  store1(y + idx, dequant(acc, scale[oc], bias != nullptr ? bias[oc] : 0.0f, bias != nullptr));
}

// ---------------------------------------------------------------- depthwise
// int8_dwconv: grouped convs with one input channel a group (Cg == 1),
// output channel oc reading input channel oc / m. It replaces
// int8_conv_direct on these shapes, which ran at 1-6% of the bound (one
// thread an output: k^2 byte loads of x and of strided weights an output,
// an input byte fetched again by each of the k^2 outputs that read it, a
// sign extension and an IMAD a multiply-accumulate, MAC).
//
// What bounds it: the bytes. The zoo's depthwise convs of a 4-page
// 736x1280 forward need 312-718 M MACs against 133-200 MB moved
// (0.037-0.060 ms at 3.35 TB/s); at the card's 16.7 T INT32 operations/s
// even one instruction a MAC would cost 19-43 us, so the kernel must read
// each byte once and spend well under an instruction a MAC. On the H100
// it reaches a fifth to a quarter of that bound summed over a model and
// up to half on the largest shapes (PERF.md §6): instruction issue and
// the latency of a block's serial steps bind it, not the memory. The
// design:
//
//  * Tiles. A block owns one image, a band of BH output rows, a span of
//    4 TG output columns and a chunk of CC input channels (m CC output
//    channels); a thread owns V channels and 4 output columns: V = 4
//    where a pixel's channels are 4-byte runs and the window is 3x3, V = 2
//    where they are 2-byte runs (ShuffleNetV2's C 58 and 116), else 1
//    (5x5 windows: four channels' sums would not fit the registers).
//  * A row ring, read once. The block walks down its input rows S at a
//    time (a step: the rows that start output row o's window, o = step);
//    each thread keeps the int32 sums of the NS = ceil(K / S) output rows
//    whose windows are open in registers and adds each input row to all
//    of them, so an input row leaves shared memory once per thread and
//    comes from device memory once per column span (the K - S halo rows
//    of two bands a second time, mostly from L2). The ring holds PF + 1
//    steps; the copies of step s + PF are in flight while step s is
//    computed: 16-byte cp.async of the 16-byte-aligned superset of the row
//    segment where the block takes every channel (a contiguous NHWC run),
//    else g-byte cp.async of each pixel's channel run (g = 16, 8 or 4 as
//    the addresses allow; plain loads for g < 4). Shared memory keeps the
//    global layout (NHWC), so any C and any base address stage alike.
//    Columns and rows outside the image are zeroed in registers, not
//    copied. One barrier a step: after it every thread is done with the
//    stage that the next copies refill.
//  * dp4a on the taps. A thread gathers the NB = 3S + K input columns of
//    its 4 outputs for each of its channels into words, 4 consecutive
//    columns a word (V = 1: byte loads; V = 2, 4: one 2- or 4-byte load a
//    pixel and a 2x4 or 4x4 byte transpose, 4 or 8 __byte_perm a 4
//    pixels). The window of output u is the bytes S u .. S u + K - 1: one
//    __byte_perm (a funnel of two words) once a row, then one __dp4a
//    against the register word (w0, w1, w2, 0) for each open output row
//    takes a 3-tap row; a 5-tap row takes two __dp4a. Dilations and
//    windows under 5x5 that are not square take the 3x3 or 5x5 form with
//    zero weights in between or after. Instructions a MAC in the step
//    (loads, transposes, windows, __dp4a; a thread's step, from the code):
//    3x3 stride 1, V = 4: 6 + 16 + 12 + 48 = 82 for 144 MACs (0.57); stride
//    2: 2 x (9 + 24 + 8) + 48 = 130 for 144 (0.90); V = 2: 6 + 8 + 6 + 24
//    = 44 for 72 (0.61), stride 2 1.03; 5x5, V = 1: stride 1 8 + ~6 + 6 +
//    40 = 60 for 100 (0.60), stride 2 0.86. The SASS adds addressing, the
//    copies and the epilogue: about 240 instructions a 5x5 step (for 100
//    MACs) in all.
//  * Epilogue: dequant() and the rounding of the GEMM, so the output
//    equals int8_conv_ref bit for bit (the int32 sums are exact in any
//    order). Each thread stores its outputs from registers: one 4-, 8- or
//    16-byte store of its V channels a column; a warp's lanes hold
//    neighbouring channels, so a store instruction covers a contiguous run
//    of the row. Staging the row in shared memory for 16-byte stores cost
//    a barrier and a copy a step, and measured slower on every model.
//  * Setup, once a block: the weights as dp4a words (for the zoo's dense
//    3x3 and 5x5 kernels from aligned 4-byte loads realigned by one
//    __byte_perm each; else tap by tap through Plan::tap), scales, bias,
//    the column masks.
//  * Filling 132 SMs (the sizing rule, launch_dw): CC = C where m C <= 128
//    (one contiguous run a row), else chunks of about 64 output channels;
//    TG = the column groups a block of at most 256 threads holds, at most
//    32 (128 columns), halved while the ring passes 24 KB, then evened
//    over the spans; BH = the largest of 32, 16, 8, 4, 2 that still gives
//    one wave (132 x the blocks an SM holds, by the occupancy calculator,
//    __launch_bounds__ asking for two), else 1. A block's setup waits for
//    its first loads, which queue behind every block's first copies, so
//    one wave of taller bands measured faster than two waves of shorter
//    ones on every model.
namespace depthwise {

constexpr int PF = 4;            // steps in flight ahead of the one computed
constexpr int STAGES = PF + 1;   // input ring stages
constexpr int MAX_THREADS = 256;
constexpr int MIN_BLOCKS = 2;    // __launch_bounds__: at most 128 registers a thread
constexpr int MAX_TG = 32;       // column groups a block: 128 output columns
constexpr int RING_BUDGET = 24 * 1024;  // bytes of the input ring

struct Plan {
  int N, H, W, C, Cout, m, kh, kw, ph, pw, Ho, Wo;
  int CC;   // input channels a block
  int run;  // 1: the block takes every channel, an input row segment is one NHWC run
  int g;    // run == 0: bytes a copy of a pixel's channel run (16, 8, 4, 2 or 1)
  int TG;   // column groups of 4 outputs a block
  int BH;   // output rows a block
  int RB;   // bytes a staged input row (a multiple of 16)
  int n_chunks, n_spans, n_bands;
  // tap[r][q]: the kernel tap (r / dh) kw + q / dw that window position
  // (r, q) of the K x K form holds, or -1 (a zero weight); dense: the
  // kernel is the K x K form itself (no dilation, kh = kw = K)
  signed char tap[5][8];
  int dense;
};

__device__ __forceinline__ void copy_bytes(uint8_t* dst, const int8_t* src, int g) {
  const uint32_t d = smem_u32(dst);
  if (g == 16) {
    cp_async16(d, src, true);
  } else if (g == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src) : "memory");
  } else if (g == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
  } else if (g == 2) {  // plain loads: cp.async copies 4, 8 or 16 bytes
    *reinterpret_cast<uint16_t*>(dst) = *reinterpret_cast<const uint16_t*>(src);
  } else {
    *dst = static_cast<uint8_t>(*src);
  }
}

// bytes o .. o + 3 of the little-endian byte string wd[0], wd[1], ... (o
// is a constant once the loops around the call are unrolled)
template <int NW>
__device__ __forceinline__ int window(const uint32_t (&wd)[NW], int o) {
  const int i = o >> 2, sh = o & 3;
  return static_cast<int>(sh == 0 ? wd[i] : __byte_perm(wd[i], wd[i + 1], 0x3210 + 0x1111 * sh));
}

// a 4x4 byte transpose: p[i] holds channels 0..3 of pixel i; c[k] gets
// channel k of pixels 0..3
__device__ __forceinline__ void transpose4(const uint32_t* p, uint32_t* c) {
  const uint32_t t0 = __byte_perm(p[0], p[1], 0x5140), t1 = __byte_perm(p[0], p[1], 0x7362);
  const uint32_t t2 = __byte_perm(p[2], p[3], 0x5140), t3 = __byte_perm(p[2], p[3], 0x7362);
  c[0] = __byte_perm(t0, t2, 0x5410);
  c[1] = __byte_perm(t0, t2, 0x7632);
  c[2] = __byte_perm(t1, t3, 0x5410);
  c[3] = __byte_perm(t1, t3, 0x7632);
}

template <int K, int S, int V, typename OutT>
__global__ void __launch_bounds__(MAX_THREADS, MIN_BLOCKS)
    int8_dwconv(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                const float* __restrict__ scale, const float* __restrict__ bias,
                OutT* __restrict__ y, Plan P) {
  constexpr int G = (K + 3) / 4;                      // dp4a words a weight row
  constexpr int NS = (K + S - 1) / S;                 // output rows open at once
  constexpr int NB = 3 * S + K;                       // input columns a thread reads a row
  constexpr int NW = (3 * S + 4 * (G - 1) + 7) / 4;   // words holding every window's bytes
  constexpr int ES = static_cast<int>(sizeof(OutT));
  static_assert(V == 1 || V == 2 || V == 4, "one, two or four channels a thread");
  extern __shared__ __align__(16) uint8_t smem[];

  const int chunk = blockIdx.x % P.n_chunks, span = blockIdx.x / P.n_chunks;
  const int band = blockIdx.y, n = blockIdx.z;
  const int c0 = chunk * P.CC, cc = min(P.CC, P.C - c0);  // input channels of the chunk
  const int OCC = P.CC * P.m, occ = cc * P.m;             // its output channels
  const int BW = 4 * P.TG, wo0 = span * BW, ob = band * P.BH;
  const int rows_out = min(P.BH, P.Ho - ob), cols_out = min(BW, P.Wo - wo0);
  const int wi_lo = wo0 * S - P.pw, SPAN = S * (BW - 1) + K;
  const int pa = max(0, -wi_lo), pb = min(SPAN, P.W - wi_lo);  // the span's columns in the image
  const int PS = P.run ? P.C : P.CC;  // bytes between two pixels of a staged row
  const int Dst = P.run ? (pa * P.C + 15) & ~15 : 0;  // where a staged run's aligned start lands
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int ncg = OCC / V, cg = tid % ncg, tg = tid / ncg;
  const int ocl0 = cg * V;         // this thread's first output channel in the chunk
  const int icl0 = ocl0 / P.m;     // its input channel in the chunk (V > 1: m == 1)
  const int P0 = 4 * S * tg;       // its first input column in the span
  uint8_t* ring = smem;
  const int8_t* ximg = x + static_cast<size_t>(n) * P.H * P.W * P.C;

  // a step's rows as offsets from the image: the first in-image byte that
  // the block reads of step s's first row is at roff(s) = roff(0) + s S W C
  // (advanced a step at a time, never multiplied out)
  const long long row_bytes = static_cast<long long>(P.W) * P.C, step_bytes = S * row_bytes;
  const long long roff0 =
      (static_cast<long long>(ob * S - P.ph) * P.W + wi_lo + pa) * P.C + c0;
  const uintptr_t xaddr = reinterpret_cast<uintptr_t>(ximg);
  // run == 0: thread tid copies unit cu of pixels cp0, cp0 + cstride, ...
  const int units = P.CC / P.g, cstride = nthr / units;
  const int cu = tid % units, cp0 = tid / units;
  const bool copier = cp0 < cstride && cu * P.g < cc;
  // the copies of step s (its rows' offsets from roff) into ring stage `stage`
  auto issue = [&](int s, int stage, long long roff) {
    for (int tr = 0; tr < S; ++tr) {
      const int hi = (ob + s) * S - P.ph + tr;
      if (hi < 0 || hi >= P.H || pa >= pb) continue;
      uint8_t* dst = ring + (stage * S + tr) * P.RB;
      const int8_t* src = ximg + roff + tr * row_bytes;
      if (P.run) {
        const int a = static_cast<int>(reinterpret_cast<uintptr_t>(src) & 15);
        const int chunks = (a + (pb - pa) * P.C + 15) >> 4;
        const uint32_t d = smem_u32(dst + Dst);
#pragma unroll 1
        for (int k = tid; k < chunks; k += nthr) cp_async16(d + 16 * k, src - a + 16 * k, true);
      } else if (copier) {
#pragma unroll 1
        for (int p = cp0; p < pb - pa; p += cstride)
          copy_bytes(dst + (pa + p) * P.CC + cu * P.g,
                     src + static_cast<size_t>(p) * P.C + cu * P.g, P.g);
      }
    }
  };

  const int steps = rows_out + NS - 1;
  for (int s = 0; s < PF; ++s) {
    if (s < steps) issue(s, s, roff0 + s * step_bytes);
    cp_async_commit();
  }
  // the thread's weights as dp4a words
  const int khw = P.kh * P.kw;
  int wr[V][K][G];
  float sc[V], bs[V];
  bool act[V];
  const bool has_bias = bias != nullptr;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int ocl = ocl0 + v;
    act[v] = ocl < occ;
    const int oc = c0 * P.m + ocl;
    sc[v] = act[v] ? scale[oc] : 0.0f;
    bs[v] = act[v] && has_bias ? bias[oc] : 0.0f;
  }
  if (P.dense) {
    // the V channels' K^2 taps each are contiguous: 4-byte loads of the
    // aligned words around them, realigned by one funnel __byte_perm each,
    // then each row's taps picked out (positions known at compile time)
    constexpr int TB = V * K * K;            // bytes of the thread's taps
    constexpr int NL = (TB + 3) / 4 + 2;     // words loaded: a row's window may read 3 past
    const int8_t* wt = w + static_cast<size_t>(act[0] ? c0 * P.m + ocl0 : 0) * khw;
    const uintptr_t wa = reinterpret_cast<uintptr_t>(wt);
    const uint32_t* wal = reinterpret_cast<const uint32_t*>(wa & ~uintptr_t(3));
    const int sh = static_cast<int>(wa & 3);
    // the last word holding a tap: no load past it
    const int last = static_cast<int>((wa + TB - 1 - (wa & ~uintptr_t(3))) >> 2);
    uint32_t lw[NL], tw[NL - 1];
#pragma unroll
    for (int k = 0; k < NL; ++k) lw[k] = wal[k < last ? k : last];
    const uint32_t sel = 0x3210 + 0x1111 * sh;
#pragma unroll
    for (int k = 0; k + 1 < NL; ++k) tw[k] = __byte_perm(lw[k], lw[k + 1], sel);
#pragma unroll
    for (int v = 0; v < V; ++v)
#pragma unroll
      for (int r = 0; r < K; ++r)
#pragma unroll
        for (int gi = 0; gi < G; ++gi) {
          const int t = v * K * K + r * K + 4 * gi;  // the word's first tap
          const int n_taps = K - 4 * gi < 4 ? K - 4 * gi : 4;
          const uint32_t word = window(tw, t);
          wr[v][r][gi] =
              act[v] ? static_cast<int>(word & (0xffffffffu >> (8 * (4 - n_taps)))) : 0;
        }
  } else {
    // P.tap says which kernel tap each window position holds (its indices
    // are compile-time, so it is read from the parameter bank); every load
    // in bounds (a clamped tap of channel 0 where inactive), so all of them
    // are in flight at once
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int8_t* wc = w + static_cast<size_t>(act[v] ? c0 * P.m + ocl0 + v : 0) * khw;
#pragma unroll
      for (int r = 0; r < K; ++r)
#pragma unroll
        for (int gi = 0; gi < G; ++gi) {
          uint32_t word = 0;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int t = P.tap[r][4 * gi + e];
            const uint32_t b = static_cast<uint8_t>(wc[act[v] && t >= 0 ? t : 0]);
            word |= (t >= 0 && act[v] ? b : 0u) << (8 * e);
          }
          wr[v][r][gi] = static_cast<int>(word);
        }
    }
  }
  // the thread's input columns that lie in the image (the span's [pa, pb)):
  // every column of the span is staged memory, so the gathers load all of
  // them and zero the others (a byte mask a word, V = 1; a word mask a
  // pixel, V = 4)
  uint32_t inside = 0, mask[NW];
#pragma unroll
  for (int p = 0; p < NB; ++p)
    if (P0 + p >= pa && P0 + p < pb) inside |= 1u << p;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    mask[i] = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (4 * i + e < NB && ((inside >> (4 * i + e)) & 1)) mask[i] |= 0xffu << (8 * e);
  }

  int acc[NS][V][4];
#pragma unroll
  for (int j = 0; j < NS; ++j)
#pragma unroll
    for (int v = 0; v < V; ++v)
#pragma unroll
      for (int u = 0; u < 4; ++u) acc[j][v][u] = 0;

  // step s adds input rows (ob + s) S - ph + tr to the open output rows
  // ob + s - NS + 1 + j, held in acc[j] (j = 0 .. NS - 1), at weight row
  // S (NS - 1 - j) + tr; then acc[0]'s row is complete and written, and the
  // rows shift. One barrier a step: after it, every thread is done with
  // step s - 1's ring stage, which is refilled then for step s + PF.
  // this thread's output row pointer at step s: yb + (s - NS + 1) Wo Cout
  OutT* const yb =
      y + ((static_cast<size_t>(n) * P.Ho + ob) * P.Wo + wo0 + 4 * tg) * P.Cout + c0 * P.m + ocl0;
  const long long out_row = static_cast<long long>(P.Wo) * P.Cout;
  long long roff = roff0, roff_next = roff0 + PF * step_bytes;  // steps s and s + PF
  int stage = 0, stage_next = PF % STAGES;
#pragma unroll 1
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<PF - 1>();  // step s's copies have landed
    __syncthreads();
    if (s + PF < steps) issue(s + PF, stage_next, roff_next);
    cp_async_commit();
#pragma unroll
    for (int tr = 0; tr < S; ++tr) {
      const int hi = (ob + s) * S - P.ph + tr;
      if (hi < 0 || hi >= P.H) continue;  // a zero row
      int off0 = 0;
      if (P.run)
        off0 = Dst + static_cast<int>((xaddr + roff + tr * row_bytes) & 15) - pa * P.C;
      const uint8_t* base = ring + (stage * S + tr) * P.RB + off0 + P0 * PS + icl0;
      uint32_t wd[V][NW];
      if constexpr (V == 1) {
#pragma unroll
        for (int i = 0; i < NW; ++i) {
          uint32_t word = 0;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int p = 4 * i + e;
            if (p < NB) word |= static_cast<uint32_t>(base[p * PS]) << (8 * e);
          }
          wd[0][i] = word & mask[i];
        }
      } else {
#pragma unroll
        for (int i = 0; i < NW; ++i) {
          uint32_t px[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int p = 4 * i + e;
            if (p < NB) {  // an unconditional load (the span is staged), then a select
              const uint32_t word = V == 4 ? *reinterpret_cast<const uint32_t*>(base + p * PS)
                                           : *reinterpret_cast<const uint16_t*>(base + p * PS);
              px[e] = (inside >> p) & 1 ? word : 0u;
            } else {
              px[e] = 0u;
            }
          }
          if constexpr (V == 4) {
            uint32_t ch[4];
            transpose4(px, ch);
#pragma unroll
            for (int v = 0; v < V; ++v) wd[v][i] = ch[v];
          } else {  // a 2x4 byte transpose: channel 0's bytes, then channel 1's
            const uint32_t a = __byte_perm(px[0], px[1], 0x5140);
            const uint32_t b = __byte_perm(px[2], px[3], 0x5140);
            wd[0][i] = __byte_perm(a, b, 0x5410);
            wd[1][i] = __byte_perm(a, b, 0x7632);
          }
        }
      }
      int win[V][4][G];  // the windows, once a row for all open output rows
#pragma unroll
      for (int v = 0; v < V; ++v)
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int gi = 0; gi < G; ++gi) win[v][u][gi] = window(wd[v], S * u + 4 * gi);
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const int r = S * (NS - 1 - j) + tr;
        // no such tap, or a row above the band or past its end
        if (r >= K || s < NS - 1 - j || s - NS + 1 + j >= rows_out) continue;
#pragma unroll
        for (int v = 0; v < V; ++v)
#pragma unroll
          for (int u = 0; u < 4; ++u)
#pragma unroll
            for (int gi = 0; gi < G; ++gi)
              acc[j][v][u] = __dp4a(win[v][u][gi], wr[v][r][gi], acc[j][v][u]);
      }
    }
    // output row o = ob + s - NS + 1 (acc[0]) is complete: each thread
    // writes its V channels (4: one 8- or 16-byte store a column) of its 4
    // columns; a warp's lanes hold neighbouring channels, so its stores
    // cover contiguous runs of the row
    if (s >= NS - 1) {
      OutT* yo = yb + (s - (NS - 1)) * out_row;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (4 * tg + u >= cols_out) continue;
        OutT* dst = yo + u * P.Cout;
        if constexpr (V == 4) {
          if (act[0])  // m == 1 and occ % 4 == 0: all four channels or none
            store4(dst, dequant(acc[0][0][u], sc[0], bs[0], has_bias),
                   dequant(acc[0][1][u], sc[1], bs[1], has_bias),
                   dequant(acc[0][2][u], sc[2], bs[2], has_bias),
                   dequant(acc[0][3][u], sc[3], bs[3], has_bias));
        } else if constexpr (V == 2) {
          if (act[0])  // m == 1 and occ % 2 == 0: both channels or none
            store2(dst, dequant(acc[0][0][u], sc[0], bs[0], has_bias),
                   dequant(acc[0][1][u], sc[1], bs[1], has_bias));
        } else {
          if (act[0]) store1(dst, dequant(acc[0][0][u], sc[0], bs[0], has_bias));
        }
      }
    }
#pragma unroll
    for (int j = 0; j + 1 < NS; ++j)
#pragma unroll
      for (int v = 0; v < V; ++v)
#pragma unroll
        for (int u = 0; u < 4; ++u) acc[j][v][u] = acc[j + 1][v][u];
#pragma unroll
    for (int v = 0; v < V; ++v)
#pragma unroll
      for (int u = 0; u < 4; ++u) acc[NS - 1][v][u] = 0;  // row o + NS opens
    roff += step_bytes;
    roff_next += step_bytes;
    stage = stage + 1 == STAGES ? 0 : stage + 1;
    stage_next = stage_next + 1 == STAGES ? 0 : stage_next + 1;
  }
}

}  // namespace depthwise

// ---------------------------------------------------------------- host
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q{};
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &q);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p)
                                                                : nullptr;
  }();
  return fn;
}

// The tensor map of a (rows, cols) int8 matrix, rows `cols` bytes apart:
// boxes of 64 bytes of K by `box_rows` rows, 64-byte swizzle, zeros outside.
bool encode(CUtensorMap* map, const void* base, int rows, int cols, int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(BK), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The weights' tensor map, encoded once per weight buffer: it holds only
// the address and the shape, so a buffer of the same shape at the same
// address (a new weight version, or a new tensor there) reuses it.
bool weight_map(CUtensorMap* map, const void* w, int rows, int cols, int box_rows) {
  static std::mutex mu;
  static std::map<std::tuple<uintptr_t, int, int, int>, CUtensorMap> cache;
  const auto key = std::make_tuple(reinterpret_cast<uintptr_t>(w), rows, cols, box_rows);
  std::lock_guard<std::mutex> lock(mu);
  const auto it = cache.find(key);
  if (it != cache.end()) {
    *map = it->second;
    return true;
  }
  if (!encode(map, w, rows, cols, box_rows)) return false;
  if (cache.size() >= 4096) cache.clear();
  cache.emplace(key, *map);
  return true;
}

int sm_count() {
  static const int n = [] {
    int dev = 0, count = 132;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    return count;
  }();
  return n;
}

constexpr int MAP_FAILED = -1;  // cuTensorMapEncodeTiled missing or refused

template <int NC, int BN, int MODE, typename OutT>
int launch_gemm(const int8_t* x, const int8_t* w, const float* scale, const float* bias, OutT* y,
                const Shape& s, cudaStream_t st) {
  using C = Cfg<NC, BN, MODE, OutT>;
  CUtensorMap ma, mb;
  std::memset(&ma, 0, sizeof(ma));
  std::memset(&mb, 0, sizeof(mb));
  if (MODE == 0 && !encode(&ma, x, s.M, s.Cin, C::BM)) return MAP_FAILED;
  if (MODE < 2 && !weight_map(&mb, w, s.Cout, s.K, BN)) return MAP_FAILED;
  auto kernel = int8_conv_wgmma<NC, BN, MODE, OutT>;
  static std::atomic<unsigned long long> attr_set{0};  // devices with the shared-memory size set
  int dev = 0;
  cudaGetDevice(&dev);
  const unsigned long long bit = 1ULL << (dev & 63);
  if (!(attr_set.load() & bit)) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set |= bit;
  }
  const long long tiles =
      static_cast<long long>((s.Cout + BN - 1) / BN) * ((s.M + C::BM - 1) / C::BM);
  kernel<<<static_cast<unsigned>(tiles), C::THREADS, C::SMEM, st>>>(ma, mb, x, w, scale, bias, y,
                                                                    s);
  return static_cast<int>(cudaGetLastError());
}

template <int NC, int BN, typename OutT>
int launch_mode(int mode, const int8_t* x, const int8_t* w, const float* scale, const float* bias,
                OutT* y, const Shape& s, cudaStream_t st) {
  if (mode == 0) return launch_gemm<NC, BN, 0>(x, w, scale, bias, y, s, st);
  if (mode == 1) return launch_gemm<NC, BN, 1>(x, w, scale, bias, y, s, st);
  if (mode == 2) return launch_gemm<1, BN, 2>(x, w, scale, bias, y, s, st);  // 64-row tiles
  return launch_gemm<NC, BN, 3>(x, w, scale, bias, y, s, st);
}

// 0: the wgmma GEMM (groups 1); 1: int8_dwconv (one input channel a group,
// a window of at most 5x5 with its dilation, equal strides of 1 or 2, at
// most 64 output channels an input channel); 2: int8_conv_direct
int route(int Cin, int Cout, int kh, int kw, int sh, int sw, int dh, int dw, int groups) {
  if (groups == 1) return 0;
  const bool window = (kh - 1) * dh + 1 <= 5 && (kw - 1) * dw + 1 <= 5;
  return Cin == groups && sh == sw && sh <= 2 && window && Cout / Cin <= 64 ? 1 : 2;
}

int blocks_per_sm(const void* kernel, int threads, int smem) {
  static std::mutex mu;
  static std::map<std::tuple<const void*, int, int, int>, int> cache;
  int dev = 0;
  cudaGetDevice(&dev);
  const auto key = std::make_tuple(kernel, threads, smem, dev);
  std::lock_guard<std::mutex> lock(mu);
  const auto it = cache.find(key);
  if (it != cache.end()) return it->second;
  int nb = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&nb, kernel, threads, smem) != cudaSuccess ||
      nb < 1)
    nb = 1;
  cache.emplace(key, nb);
  return nb;
}

int round16(int v) { return (v + 15) & ~15; }

// the band (BH) and the grid of a planned int8_dwconv launch, then the launch
template <int K, int S, int V, typename OutT>
int launch_dw_kernel(const int8_t* x, const int8_t* w, const float* scale, const float* bias,
                     OutT* y, depthwise::Plan p, int threads, int smem, cudaStream_t st) {
  auto kernel = depthwise::int8_dwconv<K, S, V, OutT>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  // BH: the largest of 32, 16, 8, 4, 2 that still fills the SMs once, else 1
  const int nb = blocks_per_sm(reinterpret_cast<const void*>(kernel), threads, smem);
  const long long per_band = static_cast<long long>(p.N) * p.n_spans * p.n_chunks;
  const long long wave = static_cast<long long>(sm_count()) * nb;
  p.BH = 1;
  for (int bh : {32, 16, 8, 4, 2})
    if (per_band * ((p.Ho + bh - 1) / bh) >= wave) {
      p.BH = bh;
      break;
    }
  p.n_bands = (p.Ho + p.BH - 1) / p.BH;
  const dim3 grid(static_cast<unsigned>(p.n_chunks * p.n_spans), static_cast<unsigned>(p.n_bands),
                  static_cast<unsigned>(p.N));
  kernel<<<grid, threads, smem, st>>>(x, w, scale, bias, y, p);
  return static_cast<int>(cudaGetLastError());
}

// int8_dwconv's tiles (the sizing rule of its note), then the launch
template <typename OutT>
int launch_dw(const int8_t* x, const int8_t* w, const float* scale, const float* bias, OutT* y,
              const Shape& s, cudaStream_t st) {
  using namespace depthwise;
  Plan p{};
  p.N = s.N, p.H = s.H, p.W = s.W, p.C = s.Cin, p.Cout = s.Cout, p.m = s.Cout / s.Cin;
  p.kh = s.kh, p.kw = s.kw, p.ph = s.ph, p.pw = s.pw;
  p.Ho = s.Ho, p.Wo = s.Wo;
  const int K = (s.kh - 1) * s.dh + 1 <= 3 && (s.kw - 1) * s.dw + 1 <= 3 ? 3 : 5, S = s.sh;
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
  int g = 16;  // the widest copy that every pixel's channel run allows
  while (g > 1 && (p.C % g != 0 || xa % g != 0)) g /= 2;
  if (p.C * p.m <= 128) {  // every channel: a row segment is one contiguous run
    p.run = 1;
    p.CC = p.C;
  } else {  // chunks of about 64 output channels, g-aligned
    p.run = 0;
    const int chunks = (p.C * p.m + 63) / 64;
    for (;;) {
      p.CC = ((p.C + chunks - 1) / chunks + g - 1) / g * g;
      if (p.CC * p.m <= MAX_THREADS || g == 1) break;
      g /= 2;
    }
  }
  p.g = g;
  p.n_chunks = (p.C + p.CC - 1) / p.CC;
  // V channels a thread (m == 1): V-byte pixel runs to load, V-element runs
  // to store; four for 3x3 windows (four channels' sums of a 5x5 window
  // would not fit the registers), else two
  auto fits = [&](int v) {
    return p.m == 1 && p.C % v == 0 && xa % v == 0 &&
           reinterpret_cast<uintptr_t>(y) % (v * sizeof(OutT)) == 0;
  };
  const int V = K == 3 && fits(4) ? 4 : K == 3 && fits(2) ? 2 : 1;
  const int OCC = p.CC * p.m, ncg = OCC / V, ES = static_cast<int>(sizeof(OutT));
  const int groups4 = (p.Wo + 3) / 4;
  auto row_bytes = [&](int tg) {
    const int span = S * (4 * tg - 1) + K;
    return round16(p.run ? round16(p.pw * p.C) + 16 + span * p.C + 16 : span * p.CC);
  };
  int TG = MAX_TG < groups4 ? MAX_TG : groups4;
  if (TG > MAX_THREADS / ncg) TG = MAX_THREADS / ncg > 1 ? MAX_THREADS / ncg : 1;
  while (TG > 1 && STAGES * S * row_bytes(TG) > RING_BUDGET) TG /= 2;
  p.n_spans = (groups4 + TG - 1) / TG;
  p.TG = (groups4 + p.n_spans - 1) / p.n_spans;  // evened over the spans
  p.RB = row_bytes(p.TG);
  p.dense = s.dh == 1 && s.dw == 1 && s.kh == K && s.kw == K;
  for (int r = 0; r < 5; ++r)
    for (int q = 0; q < 8; ++q)
      p.tap[r][q] = r < K && q < K && r % s.dh == 0 && q % s.dw == 0 && r / s.dh < s.kh &&
                            q / s.dw < s.kw
                        ? static_cast<signed char>((r / s.dh) * s.kw + q / s.dw)
                        : -1;
  const int smem = STAGES * S * p.RB, threads = ncg * p.TG;
#define LAUNCH_DW(K_, S_, V_) \
  launch_dw_kernel<K_, S_, V_>(x, w, scale, bias, y, p, threads, smem, st)
  if (K == 3 && S == 1)
    return V == 4 ? LAUNCH_DW(3, 1, 4) : V == 2 ? LAUNCH_DW(3, 1, 2) : LAUNCH_DW(3, 1, 1);
  if (K == 3) return V == 4 ? LAUNCH_DW(3, 2, 4) : V == 2 ? LAUNCH_DW(3, 2, 2) : LAUNCH_DW(3, 2, 1);
  return S == 1 ? LAUNCH_DW(5, 1, 1) : LAUNCH_DW(5, 2, 1);
#undef LAUNCH_DW
}

template <typename OutT>
int launch(const int8_t* x, const int8_t* w, const float* scale, const float* bias, OutT* y,
           const Shape& s, cudaStream_t st) {
  const int branch = route(s.Cin, s.Cout, s.kh, s.kw, s.sh, s.sw, s.dh, s.dw, s.groups);
  if (branch == 1) return launch_dw(x, w, scale, bias, y, s, st);
  if (branch == 2) {
    const size_t total = static_cast<size_t>(s.M) * s.Cout;
    const int threads = 256;
    int8_conv_direct<OutT><<<static_cast<unsigned>((total + threads - 1) / threads), threads, 0,
                             st>>>(x, w, scale, bias, y, s);
    return static_cast<int>(cudaGetLastError());
  }
  auto aligned = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  const bool vec = s.Cin % 16 == 0 && aligned(x) && aligned(w);
  const bool plain_a = s.kh == 1 && s.kw == 1 && s.sh == 1 && s.sw == 1 && s.ph == 0 && s.pw == 0;
  const int bn = s.Cout <= 64 ? 64 : 128;
  // 128-row tiles where they give two waves of the SMs or more, else 64
  const long long tiles128 = static_cast<long long>((s.Cout + bn - 1) / bn) * ((s.M + 127) / 128);
  int nc = tiles128 >= 2LL * sm_count() ? 2 : 1;
  // mode 3 where every tile lies in one output row, or straddles two (Wo
  // at least the tile), and its patch (one or two segments) fits
  auto patch_fits = [&](int rows) {
    const long long span =
        static_cast<long long>((rows - 1) * s.sw + (s.kw - 1) * s.dw + 1) * s.Cin;
    return s.Wo >= rows && (s.Wo % rows == 0 ? 1 : 2) * s.kh * span <= PATCH_BYTES;
  };
  if (!vec && !patch_fits(nc * ROW)) nc = 1;
  const int mode = vec ? (plain_a ? 0 : 1) : patch_fits(nc * ROW) ? 3 : 2;
  if (bn == 64)
    return nc == 2 ? launch_mode<2, 64>(mode, x, w, scale, bias, y, s, st)
                   : launch_mode<1, 64>(mode, x, w, scale, bias, y, s, st);
  return nc == 2 ? launch_mode<2, 128>(mode, x, w, scale, bias, y, s, st)
                 : launch_mode<1, 128>(mode, x, w, scale, bias, y, s, st);
}

}  // namespace

// y: float32 (out_bf16 == 0) or bf16 NHWC. Returns 0, a cudaError_t, or -1
// where libcuda's tensor-map encoder is missing or refuses the shape.
extern "C" int int8_conv_launch(const void* x, const void* w, const void* scale, const void* bias,
                                void* y, int N, int H, int W, int Cin, int Cout, int kh, int kw,
                                int Ho, int Wo, int sh, int sw, int ph, int pw, int dh, int dw,
                                int groups, int out_bf16, void* stream) {
  Shape s{N, H, W, Cin, Cout, kh, kw, Ho, Wo, sh, sw, ph, pw, dh, dw, groups, 0, 0, 0};
  s.Cg = Cin / groups;
  s.K = kh * kw * s.Cg;
  s.M = N * Ho * Wo;
  auto xs = static_cast<const int8_t*>(x);
  auto ws = static_cast<const int8_t*>(w);
  auto sc = static_cast<const float*>(scale);
  auto bs = static_cast<const float*>(bias);
  auto st = static_cast<cudaStream_t>(stream);
  if (out_bf16) return launch(xs, ws, sc, bs, static_cast<__nv_bfloat16*>(y), s, st);
  return launch(xs, ws, sc, bs, static_cast<float*>(y), s, st);
}

// The branch that int8_conv_launch takes for a shape: 0 the wgmma GEMM, 1
// int8_dwconv, 2 int8_conv_direct.
extern "C" int int8_conv_route(int Cin, int Cout, int kh, int kw, int sh, int sw, int dh, int dw,
                               int groups) {
  return route(Cin, Cout, kh, kw, sh, sw, dh, dw, groups);
}
