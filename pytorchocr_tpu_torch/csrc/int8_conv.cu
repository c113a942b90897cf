// int8 convolution, exact int32 sum, float32 dequant — for Hopper (sm_90a).
//
// Replaces the int8 conv that XLA lowers for the JAX package
// (pytorchocr_tpu/ops/quant.py:252, lax.conv_general_dilated(xq, wq,
// preferred_element_type=int32) and the f32 dequant after it); no Pallas
// kernel. PyTorch has no int8 convolution on CUDA.
//
//   y[m, oc] = __fadd_rn(__fmul_rn(__int2float_rn(sum_k A[m, k] * B[oc, k]), scale[oc]), bias[oc])
//
// as an implicit GEMM: M = N*Ho*Wo output pixels, N = Cout, K = kh*kw*Cin
// in (kh, kw, cin) order. x is int8 NHWC (a channels_last NCHW tensor), w
// int8 packed (Cout, kh, kw, Cin/groups), y float32 NHWC. The multiply and
// the add are separate roundings (the intrinsics are never contracted into
// an FMA), so y equals the plain version (ops/int8_conv.py:int8_conv_ref)
// bit for bit; any order of the integer sums gives the same int32.
//
// What bounds it: at the DB-ResNet18 shapes K is 147..4608 and the product
// is well above the H100's int8 ridge (1,979 TOP/s over 3.35 TB/s, ~590
// operations a byte), except the float32 output of the wide early layers
// (4 bytes an output against 2*K operations). This first design is right
// and simple, not fast: 128x64 output tiles, 4 warps of 64x32, K in steps
// of 64 through two shared-memory stages filled by cp.async (16 bytes a
// copy, zero-filled outside the image and past K), and
// mma.sync.m16n8k32.s8.s8.s32 from 32-bit fragment loads of rows padded
// to 80 bytes (no bank conflicts). Inputs whose channel count is not a
// multiple of 16 (the 3-channel stem, K = 147) take byte loads into the
// same tiles; grouped convs (groups > 1, depthwise) take a direct kernel,
// one thread an output. What it leaves out (wgmma, TMA, a persistent
// schedule, a fused BN/activation/requant epilogue, int8 or bf16 output):
// PERF.md Open questions.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int BM = 128;
constexpr int BN = 64;
constexpr int BK = 64;
constexpr int LDS = BK + 16;  // bytes a shared-memory row: 16-byte aligned, conflict-free
constexpr int THREADS = 128;

struct Shape {
  int N, H, W, Cin, Cout, kh, kw, Ho, Wo, sh, sw, ph, pw, dh, dw, groups;
  int Cg, K, M;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int src_size = valid ? 16 : 0;  // 0: write 16 zero bytes, read nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_size));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING));
}

__device__ __forceinline__ void mma_s8(int* c, const unsigned* a, const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ float dequant(int acc, float scale, const float* bias, int oc) {
  float v = __fmul_rn(__int2float_rn(acc), scale);
  return bias != nullptr ? __fadd_rn(v, bias[oc]) : v;
}

// The output pixel of GEMM row m: its image's base in x, and the input
// position of tap (0, 0).
struct RowInfo {
  const int8_t* base;
  int hi0, wi0;
  bool valid;
};

__device__ __forceinline__ RowInfo row_info(const int8_t* x, const Shape& s, int m) {
  RowInfo r;
  r.valid = m < s.M;
  int mm = r.valid ? m : 0;
  int n = mm / (s.Ho * s.Wo);
  int rem = mm - n * s.Ho * s.Wo;
  int ho = rem / s.Wo, wo = rem - (rem / s.Wo) * s.Wo;
  r.base = x + static_cast<size_t>(n) * s.H * s.W * s.Cin;
  r.hi0 = ho * s.sh - s.ph;
  r.wi0 = wo * s.sw - s.pw;
  return r;
}

// groups == 1. VEC: Cin % 16 == 0 and 16-byte aligned x and w, so every
// 16-byte run of K lies in one (kh, kw) tap and one copy fetches it.
template <bool VEC>
__global__ void __launch_bounds__(THREADS) int8_conv_gemm(const int8_t* __restrict__ x,
                                                          const int8_t* __restrict__ w,
                                                          const float* __restrict__ scale,
                                                          const float* __restrict__ bias,
                                                          float* __restrict__ y, Shape s) {
  __shared__ __align__(16) int8_t As[2][BM * LDS];
  __shared__ __align__(16) int8_t Bs[2][BN * LDS];

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const RowInfo arow = row_info(x, s, m0 + tid);  // this thread loads A row `tid`
  const int brow = tid >> 1, bchunk0 = (tid & 1) * 2;  // and two 16-byte chunks of B
  const int boc = n0 + brow;

  auto load_tile = [&](int kt, int stage) {
    const int k0 = kt * BK;
    int8_t* arow_s = &As[stage][tid * LDS];
    if constexpr (VEC) {
#pragma unroll
      for (int j = 0; j < BK / 16; ++j) {
        int k = k0 + 16 * j;
        int rs = k / s.Cin, c = k - rs * s.Cin;
        int r = rs / s.kw, q = rs - r * s.kw;
        int hi = arow.hi0 + r * s.dh, wi = arow.wi0 + q * s.dw;
        bool ok = arow.valid && k < s.K && hi >= 0 && hi < s.H && wi >= 0 && wi < s.W;
        const int8_t* src = ok ? arow.base + (static_cast<size_t>(hi) * s.W + wi) * s.Cin + c : x;
        cp_async16(arow_s + 16 * j, src, ok);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        int k = k0 + 16 * (bchunk0 + j);
        bool ok = boc < s.Cout && k < s.K;
        const int8_t* src = ok ? w + static_cast<size_t>(boc) * s.K + k : w;
        cp_async16(&Bs[stage][brow * LDS + 16 * (bchunk0 + j)], src, ok);
      }
    } else {
      // byte loads; the tap (r, q) and channel c step along K without divisions
      int k = k0;
      int rs = k / s.Cg, c = k - rs * s.Cg;
      int r = rs / s.kw, q = rs - r * s.kw;
      for (int j = 0; j < BK; ++j, ++k) {
        int8_t v = 0;
        if (arow.valid && k < s.K) {
          int hi = arow.hi0 + r * s.dh, wi = arow.wi0 + q * s.dw;
          if (hi >= 0 && hi < s.H && wi >= 0 && wi < s.W)
            v = arow.base[(static_cast<size_t>(hi) * s.W + wi) * s.Cin + c];
        }
        arow_s[j] = v;
        if (++c == s.Cg) {
          c = 0;
          if (++q == s.kw) {
            q = 0;
            ++r;
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        int kk = 16 * bchunk0 + j;
        int k2 = k0 + kk;
        Bs[stage][brow * LDS + kk] =
            (boc < s.Cout && k2 < s.K) ? w[static_cast<size_t>(boc) * s.K + k2] : int8_t(0);
      }
    }
  };

  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 1, wn = warp & 1;  // 2 x 2 warps, each 64 x 32
  const int g = lane >> 2, t = lane & 3;
  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  const int KT = (s.K + BK - 1) / BK;
  load_tile(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < KT; ++kt) {
    if (kt + 1 < KT) {
      load_tile(kt + 1, (kt + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int8_t* A = As[kt & 1];
    const int8_t* B = Bs[kt & 1];
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      unsigned a[4][4], b[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int8_t* p = A + (wm * 64 + mi * 16 + g) * LDS + kk + 4 * t;
        a[mi][0] = *reinterpret_cast<const unsigned*>(p);
        a[mi][1] = *reinterpret_cast<const unsigned*>(p + 8 * LDS);
        a[mi][2] = *reinterpret_cast<const unsigned*>(p + 16);
        a[mi][3] = *reinterpret_cast<const unsigned*>(p + 8 * LDS + 16);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int8_t* p = B + (wn * 32 + ni * 8 + g) * LDS + kk + 4 * t;
        b[ni][0] = *reinterpret_cast<const unsigned*>(p);
        b[ni][1] = *reinterpret_cast<const unsigned*>(p + 16);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], a[mi], b[ni]);
    }
    __syncthreads();
  }

  // each lane holds two neighbouring channels of a row: one 8-byte store
  // where both exist and the row start is 8-byte aligned (Cout even)
  const bool pairs = (s.Cout & 1) == 0;
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    const int oc = n0 + wn * 32 + ni * 8 + 2 * t;
    if (oc >= s.Cout) continue;
    const bool both = oc + 1 < s.Cout;
    const float sc0 = scale[oc], sc1 = both ? scale[oc + 1] : 0.0f;
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = m0 + wm * 64 + mi * 16 + g + 8 * half;
        if (m >= s.M) continue;
        float* out = y + static_cast<size_t>(m) * s.Cout + oc;
        const float v0 = dequant(acc[mi][ni][2 * half], sc0, bias, oc);
        if (both && pairs) {
          *reinterpret_cast<float2*>(out) =
              make_float2(v0, dequant(acc[mi][ni][2 * half + 1], sc1, bias, oc + 1));
        } else {
          out[0] = v0;
          if (both) out[1] = dequant(acc[mi][ni][2 * half + 1], sc1, bias, oc + 1);
        }
      }
    }
  }
}

// groups > 1 (depthwise and grouped convs): one thread an output element.
__global__ void int8_conv_direct(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                                 const float* __restrict__ scale, const float* __restrict__ bias,
                                 float* __restrict__ y, Shape s) {
  const size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<size_t>(s.M) * s.Cout) return;
  const int oc = static_cast<int>(idx % s.Cout);
  const int m = static_cast<int>(idx / s.Cout);
  const RowInfo row = row_info(x, s, m);
  const int c0 = (oc / (s.Cout / s.groups)) * s.Cg;
  int acc = 0;
  for (int r = 0; r < s.kh; ++r) {
    const int hi = row.hi0 + r * s.dh;
    if (hi < 0 || hi >= s.H) continue;
    for (int q = 0; q < s.kw; ++q) {
      const int wi = row.wi0 + q * s.dw;
      if (wi < 0 || wi >= s.W) continue;
      const int8_t* xp = row.base + (static_cast<size_t>(hi) * s.W + wi) * s.Cin + c0;
      const int8_t* wp = w + ((static_cast<size_t>(oc) * s.kh + r) * s.kw + q) * s.Cg;
      for (int c = 0; c < s.Cg; ++c) acc += int(xp[c]) * int(wp[c]);
    }
  }
  y[idx] = dequant(acc, scale[oc], bias, oc);
}

}  // namespace

extern "C" int int8_conv_launch(const void* x, const void* w, const void* scale, const void* bias,
                                void* y, int N, int H, int W, int Cin, int Cout, int kh, int kw,
                                int Ho, int Wo, int sh, int sw, int ph, int pw, int dh, int dw,
                                int groups, void* stream) {
  Shape s{N, H, W, Cin, Cout, kh, kw, Ho, Wo, sh, sw, ph, pw, dh, dw, groups, 0, 0, 0};
  s.Cg = Cin / groups;
  s.K = kh * kw * s.Cg;
  s.M = N * Ho * Wo;
  auto xs = static_cast<const int8_t*>(x);
  auto ws = static_cast<const int8_t*>(w);
  auto sc = static_cast<const float*>(scale);
  auto bs = static_cast<const float*>(bias);
  auto ys = static_cast<float*>(y);
  auto st = static_cast<cudaStream_t>(stream);
  if (groups == 1) {
    dim3 grid((s.M + BM - 1) / BM, (Cout + BN - 1) / BN);
    bool vec = Cin % 16 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0 &&
               (reinterpret_cast<uintptr_t>(w) & 15) == 0;
    if (vec)
      int8_conv_gemm<true><<<grid, THREADS, 0, st>>>(xs, ws, sc, bs, ys, s);
    else
      int8_conv_gemm<false><<<grid, THREADS, 0, st>>>(xs, ws, sc, bs, ys, s);
  } else {
    const size_t total = static_cast<size_t>(s.M) * Cout;
    const int threads = 256;
    int8_conv_direct<<<static_cast<unsigned>((total + threads - 1) / threads), threads, 0, st>>>(
        xs, ws, sc, bs, ys, s);
  }
  return static_cast<int>(cudaGetLastError());
}
