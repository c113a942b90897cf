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
// Grouped and depthwise convs (groups > 1, not on the DB path) keep a
// direct kernel, one thread an output. What it leaves out (a persistent
// schedule, split-K, a fused BN/activation/requant epilogue): PERF.md Open
// questions.

#include <cuda.h>  // CUtensorMap and its enums; cuTensorMapEncodeTiled comes by entry point
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>
#include <cstring>
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

// groups > 1 (depthwise and grouped convs): one thread an output element.
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

template <typename OutT>
int launch(const int8_t* x, const int8_t* w, const float* scale, const float* bias, OutT* y,
           const Shape& s, cudaStream_t st) {
  if (s.groups != 1) {
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
