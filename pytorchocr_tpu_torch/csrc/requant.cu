// The int8 requantize passes of the PTQ path in one elementwise kernel — for
// Hopper (sm_90a).
//
// Replaces the XLA fusions that the JAX package's int8 elementwise ops
// compile to (pytorchocr_tpu/ops/quant.py:119-122 `_quantize`, 140-163
// `dequant`, `qtensor_from`, `qadd_act`); no Pallas kernel. The port ran each
// as a chain of PyTorch kernels, each writing a float32 temporary (about 35
// bytes of traffic an element for a quantize, 75 for a residual add). Here
// each is one pass: every input element read once, every output written
// once, which is what bounds it (bytes, at 3.35 TB/s).
//
//   quantize:          q = clamp(rint(v / s_out), -127, 127) as int8
//   dequant:           y = out(v)
//   add_act_quantize:  q = quantize(relu?(a + b))
//
// where an int8 operand's value is __fmul_rn(float(q), s), a float32 one
// its value and a bf16 one its value widened; a + b follows torch's type
// promotion: float32 unless both operands are bf16 tensors, whose float sum
// is rounded to bf16 (round to nearest even) before the relu. The division
// is IEEE (__fdiv_rn), the rounding half to even (rintf), nothing is
// contracted into an FMA, and bf16 outputs round to nearest even: the
// result equals the plain PyTorch version (ops/requant.py) bit for bit.
// Scales are 0-d float32 device tensors read in the kernel (no host sync).
//
// Design: 16 elements a thread over the memory order of the tensors (a
// contiguous or channels_last tensor is one dense run; the operands share
// their strides), as 16-byte loads and stores where every pointer is
// 16-byte aligned; the last partial group and unaligned tensors take
// element loads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

enum Kind { NONE = 0, I8 = 1, F32 = 2, BF16 = 3 };

constexpr int EPT = 16;  // elements a thread
constexpr int THREADS = 256;

template <int K>
__device__ __forceinline__ float value(const void* p, long long i, float s) {
  if constexpr (K == I8) return __fmul_rn(static_cast<float>(static_cast<const int8_t*>(p)[i]), s);
  if constexpr (K == F32) return static_cast<const float*>(p)[i];
  return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
}

// the 16 values of elements i .. i + 15, from 16-byte loads
template <int K>
__device__ __forceinline__ void values16(const void* p, long long i, float s, float* v) {
  if constexpr (K == I8) {
    const uint4 u = *reinterpret_cast<const uint4*>(static_cast<const int8_t*>(p) + i);
    const uint32_t wd[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int e = 0; e < 16; ++e)
      v[e] = __fmul_rn(static_cast<float>(static_cast<int8_t>(wd[e >> 2] >> (8 * (e & 3)))), s);
  } else if constexpr (K == F32) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float4 f = *reinterpret_cast<const float4*>(static_cast<const float*>(p) + i + 4 * j);
      v[4 * j] = f.x;
      v[4 * j + 1] = f.y;
      v[4 * j + 2] = f.z;
      v[4 * j + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const uint4 u =
          *reinterpret_cast<const uint4*>(static_cast<const __nv_bfloat16*>(p) + i + 8 * j);
      const uint32_t wd[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int e = 0; e < 8; ++e)
        v[8 * j + e] = __uint_as_float((wd[e >> 1] >> (16 * (e & 1))) << 16);  // bf16 -> float
    }
  }
}

template <int KA, int KB>
__device__ __forceinline__ float combine(float a, float b, bool relu) {
  float v = a;
  if constexpr (KB != NONE) {
    v = __fadd_rn(a, b);
    if constexpr (KA == BF16 && KB == BF16) v = __bfloat162float(__float2bfloat16_rn(v));
  }
  if (relu) v = v > 0.0f ? v : 0.0f;
  return v;
}

__device__ __forceinline__ int8_t quantize(float v, float s) {
  const float r = fminf(fmaxf(rintf(__fdiv_rn(v, s)), -127.0f), 127.0f);
  return static_cast<int8_t>(static_cast<int>(r));
}

template <int KO>
__device__ __forceinline__ void put(void* out, long long i, float v, float so) {
  if constexpr (KO == I8) static_cast<int8_t*>(out)[i] = quantize(v, so);
  if constexpr (KO == F32) static_cast<float*>(out)[i] = v;
  if constexpr (KO == BF16) static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16_rn(v);
}

template <int KO>
__device__ __forceinline__ void put16(void* out, long long i, const float* v, float so) {
  if constexpr (KO == I8) {
    uint32_t wd[4] = {0, 0, 0, 0};
#pragma unroll
    for (int e = 0; e < 16; ++e)
      wd[e >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(quantize(v[e], so)))
                    << (8 * (e & 3));
    *reinterpret_cast<uint4*>(static_cast<int8_t*>(out) + i) =
        make_uint4(wd[0], wd[1], wd[2], wd[3]);
  } else if constexpr (KO == F32) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(static_cast<float*>(out) + i + 4 * j) =
          make_float4(v[4 * j], v[4 * j + 1], v[4 * j + 2], v[4 * j + 3]);
  } else {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      uint32_t wd[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const __nv_bfloat162 h = __halves2bfloat162(__float2bfloat16_rn(v[8 * j + 2 * e]),
                                                    __float2bfloat16_rn(v[8 * j + 2 * e + 1]));
        wd[e] = *reinterpret_cast<const uint32_t*>(&h);
      }
      *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(out) + i + 8 * j) =
          make_uint4(wd[0], wd[1], wd[2], wd[3]);
    }
  }
}

template <int KA, int KB, int KO, bool VEC>
__global__ void __launch_bounds__(THREADS)
    requant_kernel(const void* __restrict__ a, const float* __restrict__ sa,
                   const void* __restrict__ b, const float* __restrict__ sb,
                   const float* __restrict__ so, void* __restrict__ out, long long n, int relu) {
  const long long i0 = (static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x) * EPT;
  if (i0 >= n) return;
  const float s_a = KA == I8 ? *sa : 0.0f;
  const float s_b = KB == I8 ? *sb : 0.0f;
  const float s_o = KO == I8 ? *so : 0.0f;
  if (VEC && i0 + EPT <= n) {
    float va[EPT], vb[EPT];
    values16<KA>(a, i0, s_a, va);
    if constexpr (KB != NONE) values16<KB>(b, i0, s_b, vb);
#pragma unroll
    for (int e = 0; e < EPT; ++e) va[e] = combine<KA, KB>(va[e], KB != NONE ? vb[e] : 0.0f, relu);
    put16<KO>(out, i0, va, s_o);
    return;
  }
  const long long end = i0 + EPT < n ? i0 + EPT : n;
  for (long long i = i0; i < end; ++i) {
    const float vb = KB != NONE ? value<KB == NONE ? F32 : KB>(b, i, s_b) : 0.0f;
    put<KO>(out, i, combine<KA, KB>(value<KA>(a, i, s_a), vb, relu), s_o);
  }
}

template <int KA, int KB, int KO>
int launch(const void* a, const float* sa, const void* b, const float* sb, const float* so,
           void* out, long long n, int relu, cudaStream_t st) {
  if (n <= 0) return 0;
  auto aligned = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  const bool vec = aligned(a) && (KB == NONE || aligned(b)) && aligned(out);
  const long long blocks = (n + static_cast<long long>(EPT) * THREADS - 1) / (EPT * THREADS);
  if (vec)
    requant_kernel<KA, KB, KO, true>
        <<<static_cast<unsigned>(blocks), THREADS, 0, st>>>(a, sa, b, sb, so, out, n, relu);
  else
    requant_kernel<KA, KB, KO, false>
        <<<static_cast<unsigned>(blocks), THREADS, 0, st>>>(a, sa, b, sb, so, out, n, relu);
  return static_cast<int>(cudaGetLastError());
}

constexpr int BAD_KIND = -1;

template <int KA>
int launch_add(int kb, const void* a, const float* sa, const void* b, const float* sb,
               const float* so, void* q, long long n, int relu, cudaStream_t st) {
  if (kb == I8) return launch<KA, I8, I8>(a, sa, b, sb, so, q, n, relu, st);
  if (kb == F32) return launch<KA, F32, I8>(a, sa, b, sb, so, q, n, relu, st);
  if (kb == BF16) return launch<KA, BF16, I8>(a, sa, b, sb, so, q, n, relu, st);
  return BAD_KIND;
}

}  // namespace

// kinds: 1 int8, 2 float32, 3 bf16. Each returns 0, a cudaError_t, or -1
// for a kind it does not take.

// q = quantize(x, scale): x float32 or bf16
extern "C" int requant_quantize(const void* x, int kx, const void* scale, void* q, long long n,
                                void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  auto so = static_cast<const float*>(scale);
  if (kx == F32) return launch<F32, NONE, I8>(x, nullptr, nullptr, nullptr, so, q, n, 0, st);
  if (kx == BF16) return launch<BF16, NONE, I8>(x, nullptr, nullptr, nullptr, so, q, n, 0, st);
  return BAD_KIND;
}

// y = dequant(q, scale) as float32 or bf16
extern "C" int requant_dequant(const void* q, const void* scale, void* y, int ky, long long n,
                               void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  auto sq = static_cast<const float*>(scale);
  if (ky == F32) return launch<I8, NONE, F32>(q, sq, nullptr, nullptr, nullptr, y, n, 0, st);
  if (ky == BF16) return launch<I8, NONE, BF16>(q, sq, nullptr, nullptr, nullptr, y, n, 0, st);
  return BAD_KIND;
}

// q = quantize(relu?(a + b), out_scale): each operand int8 (with its scale)
// or float32 or bf16 (scale unused)
extern "C" int requant_add(const void* a, int ka, const void* scale_a, const void* b, int kb,
                           const void* scale_b, const void* out_scale, void* q, long long n,
                           int relu, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  auto sa = static_cast<const float*>(scale_a);
  auto sb = static_cast<const float*>(scale_b);
  auto so = static_cast<const float*>(out_scale);
  if (ka == I8) return launch_add<I8>(kb, a, sa, b, sb, so, q, n, relu, st);
  if (ka == F32) return launch_add<F32>(kb, a, sa, b, sb, so, q, n, relu, st);
  if (ka == BF16) return launch_add<BF16>(kb, a, sa, b, sb, so, q, n, relu, st);
  return BAD_KIND;
}
