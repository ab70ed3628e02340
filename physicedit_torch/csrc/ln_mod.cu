// ln_mod_kernel: the DiT block's bf16 modulated LayerNorm,
//   y = bf16(bf16(bf16(LN(x)) * bf16(1 + scale)) + shift),
// and, in its residual form, the gated residual in front of it,
//   x' = bf16(x + bf16(gate * o)),  y = the same of x'.
// x [B, S, D] may be a row-strided view (the slim last block's first rows);
// o, x' and y are contiguous [B, S, D]; shift, scale and gate are rows
// [B, D] of a modulation output (their batch stride 3 D or 6 D).
//
// Replaces no TPU kernel: the JAX package leaves the modulated LayerNorm
// (models/dit.py's modulate) and the gated residuals to XLA, which fuses
// them.  The port ran them as eager ATen ops (models/dit.py _modulate: an
// fp32 LayerNorm of seven passes, then the affine's three, ~11 launches a
// call; each gated residual two more), over fp32 copies of x.
//
// Numerics: the eager ops' roundings, with only the order of the statistics'
// sums changed.
//   mean = (fp32 sum of x) * fp32(1 / D)      ATen's mean
//   var  = (fp32 sum of (x - mean)^2) / D     ATen's population variance
//   ln   = bf16((x - mean) * rsqrtf(var + eps))   the cast before the affine
//   y    = bf16(bf16(ln * bf16(1 + scale)) + shift)
//   x'   = bf16(x + bf16(gate * o))
// The affine's and the residual's operands are bf16: a product of two is
// exact in fp32 and a sum of two is rounded once to bf16 either way, so
// bf16x2 mul.rn / add.rn (explicit rounding, never contracted into an fma)
// give the bits of ATen's fp32 op followed by its cast.
//
// What bounds it on an H100: device memory.  ln_mod reads x and writes y
// once: at the image stream's [2, 8192, 3072], 100.7 MB each way, 0.060 ms
// at 3.35 TB/s.  residual_ln_mod reads x and o and writes x' and y, 402.7 MB,
// 0.120 ms.  shift, scale and gate (6 KB a batch row) stay in L1 / L2.
//
// Design: a warp takes one (batch, token) row.  A lane owns 8 elements (16
// bytes) of each 256-wide chunk, so a warp's load of a chunk is one
// contiguous 512 bytes, and the row's D / 256 chunks (12 at D = 3072) are
// all loaded before any is used and stay in registers as packed bf16 (48
// registers at D 3072): exact two-pass statistics from registers, each sum
// reduced by 5 shuffles, no shared memory.  Blocks of 8 rows (6 in the
// residual form, which holds o too), two an SM: 12-16 rows' loads in flight
// on each SM cover the memory's latency.  x and o are streamed (read once).
#include "common.cuh"

namespace {

// Threads a block: the residual form holds x and o (96 registers of data
// at D 3072), so its blocks are smaller, for two blocks an SM within the
// registers (170 a thread) without spills
template <bool kResidual>
constexpr int kThreads = kResidual ? 192 : 256;
constexpr int kChunk = 32 * 8;  // elements of a warp's 16-byte-a-lane load
constexpr int kMaxChunks = 12;  // D up to 3072
constexpr uint32_t kOnes = 0x3F803F80u;  // bf16x2 (1, 1)

struct Params {
  const uint16_t* x;  // [B, S, D], element strides batch / row
  long long x_batch, x_row;
  const uint16_t* o;  // [B, S, D] contiguous (residual form)
  const uint16_t* gate;  // [B, D] rows, element stride batch
  long long gate_batch;
  const uint16_t* shift;
  long long shift_batch;
  const uint16_t* scale;
  long long scale_batch;
  uint16_t* x_out;  // [B, S, D] contiguous (residual form)
  uint16_t* y;      // [B, S, D] contiguous
  int batch, seq;
  float eps;
};

__device__ __forceinline__ float bf_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf_hi(uint32_t w) { return __uint_as_float(w & 0xFFFF0000u); }

// Two floats rounded to bf16, lo in the low half.
__device__ __forceinline__ uint32_t bf_pack(float lo, float hi) {
  uint32_t d;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(d) : "f"(hi), "f"(lo));
  return d;
}

__device__ __forceinline__ uint32_t mul_bf2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

__device__ __forceinline__ uint32_t add_bf2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("add.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ uint4 ld_stream(const uint16_t* p) {
  return __ldcs(reinterpret_cast<const uint4*>(p));
}

__device__ __forceinline__ uint4 ld_rows(const uint16_t* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

__device__ __forceinline__ void st(uint16_t* p, uint4 v) { *reinterpret_cast<uint4*>(p) = v; }

// One warp a row; kChunks chunks of 256 elements (D = 256 kChunks).
template <int kChunks, bool kResidual>
__global__ void __launch_bounds__(kThreads<kResidual>, 2) ln_mod_kernel(const Params p) {
  constexpr int d = kChunks * kChunk;
  const long long row =
      static_cast<long long>(blockIdx.x) * (kThreads<kResidual> / 32) + threadIdx.x / 32;
  if (row >= static_cast<long long>(p.batch) * p.seq) return;
  const int b = static_cast<int>(row / p.seq), s = static_cast<int>(row % p.seq);
  const int col = 8 * (threadIdx.x & 31);
  const long long out_at = row * d + col;

  uint4 v[kChunks];
  const uint16_t* xs = p.x + b * p.x_batch + s * p.x_row + col;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) v[c] = ld_stream(xs + c * kChunk);
  if constexpr (kResidual) {
    uint4 o[kChunks];
#pragma unroll
    for (int c = 0; c < kChunks; ++c) o[c] = ld_stream(p.o + out_at + c * kChunk);
    const uint16_t* gs = p.gate + b * p.gate_batch + col;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const uint4 g = ld_rows(gs + c * kChunk);
      v[c] = make_uint4(add_bf2(v[c].x, mul_bf2(g.x, o[c].x)),
                        add_bf2(v[c].y, mul_bf2(g.y, o[c].y)),
                        add_bf2(v[c].z, mul_bf2(g.z, o[c].z)),
                        add_bf2(v[c].w, mul_bf2(g.w, o[c].w)));
      st(p.x_out + out_at + c * kChunk, v[c]);
    }
  }

  float sum = 0.f;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const uint32_t w[4] = {v[c].x, v[c].y, v[c].z, v[c].w};
#pragma unroll
    for (int i = 0; i < 4; ++i) sum = __fadd_rn(__fadd_rn(sum, bf_lo(w[i])), bf_hi(w[i]));
  }
  const float mean = __fmul_rn(warp_sum(sum), 1.f / d);
  float m2 = 0.f;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const uint32_t w[4] = {v[c].x, v[c].y, v[c].z, v[c].w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float lo = __fsub_rn(bf_lo(w[i]), mean), hi = __fsub_rn(bf_hi(w[i]), mean);
      m2 = fmaf(hi, hi, fmaf(lo, lo, m2));
    }
  }
  const float r = rsqrtf(__fadd_rn(__fdiv_rn(warp_sum(m2), static_cast<float>(d)), p.eps));

  const uint16_t* scs = p.scale + b * p.scale_batch + col;
  const uint16_t* shs = p.shift + b * p.shift_batch + col;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const uint4 a = ld_rows(scs + c * kChunk), h = ld_rows(shs + c * kChunk);
    const uint32_t w[4] = {v[c].x, v[c].y, v[c].z, v[c].w};
    const uint32_t sc[4] = {a.x, a.y, a.z, a.w}, sh[4] = {h.x, h.y, h.z, h.w};
    uint32_t y[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t ln = bf_pack(__fmul_rn(__fsub_rn(bf_lo(w[i]), mean), r),
                                  __fmul_rn(__fsub_rn(bf_hi(w[i]), mean), r));
      y[i] = add_bf2(mul_bf2(ln, add_bf2(kOnes, sc[i])), sh[i]);
    }
    st(p.y + out_at + c * kChunk, make_uint4(y[0], y[1], y[2], y[3]));
  }
}

template <bool kResidual, int kChunks = 1>
int launch(const Params& p, int chunks, cudaStream_t stream) {
  if constexpr (kChunks <= kMaxChunks) {
    if (chunks != kChunks) return launch<kResidual, kChunks + 1>(p, chunks, stream);
    const long long rows = static_cast<long long>(p.batch) * p.seq;
    if (rows == 0) return 0;
    constexpr int warps = kThreads<kResidual> / 32;
    const long long grid = (rows + warps - 1) / warps;
    ln_mod_kernel<kChunks, kResidual>
        <<<static_cast<unsigned>(grid), kThreads<kResidual>, 0, stream>>>(p);
    return static_cast<int>(cudaGetLastError());
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// y = the modulated LayerNorm of x.  x: element strides of its batch and
// token rows; shift / scale: element strides of their batch rows; d a
// multiple of 256 up to 3072.
extern "C" int ln_mod_bf16(const void* x, long long x_batch, long long x_row, const void* shift,
                           long long shift_batch, const void* scale, long long scale_batch,
                           void* y, int batch, int seq, int d, float eps, void* stream) {
  const Params p{static_cast<const uint16_t*>(x), x_batch, x_row, nullptr, nullptr, 0,
                 static_cast<const uint16_t*>(shift), shift_batch,
                 static_cast<const uint16_t*>(scale), scale_batch, nullptr,
                 static_cast<uint16_t*>(y), batch, seq, eps};
  return launch<false>(p, d / kChunk, static_cast<cudaStream_t>(stream));
}

// x_out = x + gate * o, and y = the modulated LayerNorm of x_out; o
// contiguous [batch, seq, d].
extern "C" int residual_ln_mod_bf16(const void* x, long long x_batch, long long x_row,
                                    const void* o, const void* gate, long long gate_batch,
                                    const void* shift, long long shift_batch, const void* scale,
                                    long long scale_batch, void* x_out, void* y, int batch,
                                    int seq, int d, float eps, void* stream) {
  const Params p{static_cast<const uint16_t*>(x), x_batch, x_row,
                 static_cast<const uint16_t*>(o), static_cast<const uint16_t*>(gate), gate_batch,
                 static_cast<const uint16_t*>(shift), shift_batch,
                 static_cast<const uint16_t*>(scale), scale_batch, static_cast<uint16_t*>(x_out),
                 static_cast<uint16_t*>(y), batch, seq, eps};
  return launch<true>(p, d / kChunk, static_cast<cudaStream_t>(stream));
}
