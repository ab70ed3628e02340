// T6: one elementwise pass, y = x * c + d, bf16 or fp32, to pin the card's
// elementwise memory rate with a known access width.
//
// Replaces tools/proto_ew_rate.py::pallas_scale (body _scale_kernel), the
// Pallas prototype its measurement tool drives (the port of both is
// physicedit_torch/tools/proto_ew_rate.py).  c = 0.999 and d = 1e-4 are
// rounded to x's dtype first, as jnp.asarray(0.999, x.dtype) does (in bf16
// c = 1.0 and d = 1.0014e-4); the wrapper passes them as fp32 values.  The
// product and the sum are each rounded in fp32 (__fmul_rn, __fadd_rn: no FMA
// contraction), then to bf16 for bf16 x, which equals bf16 arithmetic here:
// x * 1.0 is exact, and x + d in fp32 is exact or far from a bf16 tie.
//
// What bounds it on an H100: the bytes, one read and one write of x at 3.35
// TB/s (0.186 ms for the [16896, 9216] bf16 DiT activation).  Design: one
// grid-stride pass over 16-byte vectors (8 bf16 or 4 fp32 a thread a step),
// a few blocks per SM; the elements past the last whole vector by a scalar
// tail.
#include "common.cuh"

namespace {

constexpr int kEwThreads = 256;

__device__ __forceinline__ float scale_one(float x, float c, float d) {
  return __fadd_rn(__fmul_rn(x, c), d);
}

__device__ __forceinline__ uint32_t scale_bf16x2(uint32_t w, float c, float d) {
  const __nv_bfloat162 x = *reinterpret_cast<const __nv_bfloat162*>(&w);
  const __nv_bfloat162 y = __floats2bfloat162_rn(scale_one(__low2float(x), c, d),
                                                 scale_one(__high2float(x), c, d));
  return *reinterpret_cast<const uint32_t*>(&y);
}

// template arguments are ints so that they mangle as Li<n>E, which
// chip_smoke.py reads out of the ptxas report
template <int kBf16>
__global__ void __launch_bounds__(kEwThreads)
ew_scale_kernel(const void* __restrict__ x, void* __restrict__ out, long n, float c, float d) {
  constexpr int kPerVec = kBf16 ? 8 : 4;
  const long n_vec = n / kPerVec;
  const uint4* xv = static_cast<const uint4*>(x);
  uint4* ov = static_cast<uint4*>(out);
  const long stride = (long)gridDim.x * blockDim.x;
  for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x; i < n_vec; i += stride) {
    uint4 w = __ldg(xv + i);
    if constexpr (kBf16) {
      w.x = scale_bf16x2(w.x, c, d);
      w.y = scale_bf16x2(w.y, c, d);
      w.z = scale_bf16x2(w.z, c, d);
      w.w = scale_bf16x2(w.w, c, d);
    } else {
      w.x = __float_as_uint(scale_one(__uint_as_float(w.x), c, d));
      w.y = __float_as_uint(scale_one(__uint_as_float(w.y), c, d));
      w.z = __float_as_uint(scale_one(__uint_as_float(w.z), c, d));
      w.w = __float_as_uint(scale_one(__uint_as_float(w.w), c, d));
    }
    ov[i] = w;
  }
  if (blockIdx.x == 0) {
    for (long i = n_vec * kPerVec + threadIdx.x; i < n; i += blockDim.x) {
      if constexpr (kBf16) {
        const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
        static_cast<__nv_bfloat16*>(out)[i] =
            __float2bfloat16_rn(scale_one(__bfloat162float(xb[i]), c, d));
      } else {
        static_cast<float*>(out)[i] = scale_one(static_cast<const float*>(x)[i], c, d);
      }
    }
  }
}

template <int kBf16>
int launch(const void* x, void* out, long n, float c, float d, cudaStream_t stream) {
  static int sms = 0;  // the one card's SM count, read at the first launch
  if (sms == 0) {
    int device = 0;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  const long n_vec = n / (kBf16 ? 8 : 4);
  const long want = (n_vec + kEwThreads - 1) / kEwThreads;
  const int blocks = static_cast<int>(want < 8L * sms ? (want > 0 ? want : 1) : 8L * sms);
  ew_scale_kernel<kBf16><<<blocks, kEwThreads, 0, stream>>>(x, out, n, c, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x and out: n contiguous bf16 (bf16 = 1) or fp32 (bf16 = 0) values, 16-byte
// aligned; c and d already rounded to x's dtype.
extern "C" int proto_ew_scale(int bf16, const void* x, void* out, long n, float c, float d,
                              void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bf16) {
    case 0: return launch<0>(x, out, n, c, d, s);  // fp32
    case 1: return launch<1>(x, out, n, c, d, s);  // bf16
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
