// qk_norm_rope_kernel: the DiT block's per-head q / k RMSNorm, gain and RoPE,
// and the v copy, read from both streams' QKV projections ([B, S, 3 N 128]
// bf16: q heads, k heads, v heads) and written straight into the joint
// [B, N, S_t + S_i, 128] q, k and v buffers the attention reads: the text
// stream's rows at [0, S_t), the image stream's at [S_t, S_t + S_i).  One
// launch takes both streams.  The slim last block asks for q of the first
// image rows only (q [B, N, slim, 128]); its k and v stay whole.
//
// Replaces no TPU kernel: the JAX package leaves rms_norm (ops/norms.py) and
// apply_rope (ops/rope.py) to XLA, which fuses them; the port ran them as
// eager ATen ops in fp32 (~70 launches a block) and joined the streams with
// three torch.cat.
//
// Numerics: the eager path's roundings (ops/norms.rms_norm, then
// ops/rope.apply_rope), with only the order of the 128-term sum of squares
// changed:
//   var = (fp32 sum of the squares of the bf16 inputs) * (1 / 128)
//   r   = bf16(rsqrtf(var + eps))       ATen's CUDA rsqrt is ::rsqrt
//   y   = bf16(bf16(x * r) * gain)
//   (y0, y1) -> (bf16(y0 c - y1 s), bf16(y1 c + y0 s)) on adjacent pairs, each
//   product and the difference or sum rounded on its own (no FMA).
//
// What bounds it on an H100: device memory.  Each token reads its QKV row
// once (3 N 256 bytes) and writes q, k and v once (the same bytes): at the
// 1024^2 edit's B2 N24 S 8832, 651 MB a block (656 MB with the RoPE tables),
// 0.196 ms at 3.35 TB/s.
//
// Design: a warp takes one (batch, token) row of one stream.  Each lane of a
// half-warp owns 8 elements (16 bytes) of a 128-wide head row, so it loads
// the token's cos and sin of its four pairs once (two 16-byte loads) and the
// gains of its elements once.  The warp then walks the q and k head rows, a
// half-warp a head row, kUnroll rows per half-warp loaded before any is used,
// the sum of squares reduced by 4 shuffles inside the half-warp; then the v
// head rows, copied the same way.  Loads are streamed (read once); every
// store is a half-warp's contiguous 256 bytes.
#include "common.cuh"

namespace {

constexpr int kHeadDim = 128;
constexpr int kPairs = kHeadDim / 2;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 6;  // head rows a half-warp has in flight

// One stream's operands and where its rows land.
struct Stream {
  const uint16_t* qkv;  // [B, S, 3 N 128], element strides batch / row
  long long batch, row;
  const float* cos;     // [S, 64] (table_batch 0) or [B, 1, S, 64]
  const float* sin;
  long long table_batch;
  const uint16_t* gain_q;  // [128] bf16
  const uint16_t* gain_k;
  int seq;     // S of the stream
  int joint0;  // its first row on k's and v's joint axis
  int q0;      // its first row in q
  int q_rows;  // its first q_rows tokens have a q row
};

struct Params {
  Stream txt, img;
  uint16_t* q;  // [B, N, q_len, 128]
  uint16_t* k;  // [B, N, joint, 128]
  uint16_t* v;
  int batch, heads, joint, q_len;
  float eps;
};

__device__ __forceinline__ float bf_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf_hi(uint32_t w) { return __uint_as_float(w & 0xFFFF0000u); }

__device__ __forceinline__ float bf_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Two floats rounded to bf16, lo in the low half.
__device__ __forceinline__ uint32_t bf_pack(float lo, float hi) {
  uint32_t d;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(d) : "f"(hi), "f"(lo));
  return d;
}

__device__ __forceinline__ uint4 load_row16(const uint16_t* p) {
  return __ldcs(reinterpret_cast<const uint4*>(p));
}

// One lane's 8 elements of a head row: RMSNorm over the half-warp's 128, the
// gain, RoPE on the lane's four pairs.  Every lane of the warp calls it (the
// shuffles), a lane with no head row on zeros.
__device__ __forceinline__ uint4 norm_rope(uint4 raw, uint4 gain, float4 c, float4 s,
                                           float eps) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
  const uint32_t g[4] = {gain.x, gain.y, gain.z, gain.w};
  float x[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) x[2 * i] = bf_lo(w[i]), x[2 * i + 1] = bf_hi(w[i]);
  float ss = 0.f;  // the squares of bf16 values are exact in fp32
#pragma unroll
  for (int i = 0; i < 8; ++i) ss = __fadd_rn(ss, __fmul_rn(x[i], x[i]));
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) ss = __fadd_rn(ss, __shfl_xor_sync(0xffffffffu, ss, off));
  const float r = bf_round(rsqrtf(__fadd_rn(__fmul_rn(ss, 1.f / kHeadDim), eps)));
  float y[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    y[2 * i] = bf_round(__fmul_rn(bf_round(__fmul_rn(x[2 * i], r)), bf_lo(g[i])));
    y[2 * i + 1] = bf_round(__fmul_rn(bf_round(__fmul_rn(x[2 * i + 1], r)), bf_hi(g[i])));
  }
  const float cs[4] = {c.x, c.y, c.z, c.w}, sn[4] = {s.x, s.y, s.z, s.w};
  uint32_t o[4];
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const float y0 = y[2 * p], y1 = y[2 * p + 1];
    o[p] = bf_pack(__fsub_rn(__fmul_rn(y0, cs[p]), __fmul_rn(y1, sn[p])),
                   __fadd_rn(__fmul_rn(y1, cs[p]), __fmul_rn(y0, sn[p])));
  }
  return make_uint4(o[0], o[1], o[2], o[3]);
}

// Token s of batch row b of stream st: its q (if it has a q row), k and v
// head rows.
__device__ __forceinline__ void token(const Stream& st, const Params& p, int b, int s) {
  const int lane = threadIdx.x & 31, half = lane >> 4, hl = lane & 15;
  const int n = p.heads;
  const uint16_t* src = st.qkv + b * st.batch + s * st.row + 8 * hl;
  const long long tab = b * st.table_batch + static_cast<long long>(s) * kPairs + 4 * hl;
  const float4 c = *reinterpret_cast<const float4*>(st.cos + tab);
  const float4 sn = *reinterpret_cast<const float4*>(st.sin + tab);
  const uint4 gq = *reinterpret_cast<const uint4*>(st.gain_q + 8 * hl);
  const uint4 gk = *reinterpret_cast<const uint4*>(st.gain_k + 8 * hl);
  const long long head_kv = static_cast<long long>(p.joint) * kHeadDim;
  const long long head_q = static_cast<long long>(p.q_len) * kHeadDim;
  const long long kv_at = (static_cast<long long>(b) * n * p.joint + st.joint0 + s) * kHeadDim;
  uint16_t* kd = p.k + kv_at + 8 * hl;
  uint16_t* vd = p.v + kv_at + 8 * hl;
  uint16_t* qd = p.q + (static_cast<long long>(b) * n * p.q_len + st.q0 + s) * kHeadDim + 8 * hl;

  // q and k: head row j < n is q head j, j >= n k head j - n; its source
  // columns start at 128 j.  The walk is the same for the whole warp.
  for (int base = s < st.q_rows ? 0 : n; base < 2 * n; base += 2 * kUnroll) {
    uint4 x[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = base + 2 * u + half;
      x[u] = j < 2 * n ? load_row16(src + j * kHeadDim) : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = base + 2 * u + half;
      const bool is_k = j >= n;
      const uint4 y = norm_rope(x[u], is_k ? gk : gq, c, sn, p.eps);
      if (j < 2 * n)
        *reinterpret_cast<uint4*>(is_k ? kd + (j - n) * head_kv : qd + j * head_q) = y;
    }
  }
  // v: head h's source columns start at 128 (2 n + h)
  for (int base = 0; base < n; base += 2 * kUnroll) {
    uint4 x[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int h = base + 2 * u + half;
      if (h < n) x[u] = load_row16(src + (2 * n + h) * kHeadDim);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int h = base + 2 * u + half;
      if (h < n) *reinterpret_cast<uint4*>(vd + h * head_kv) = x[u];
    }
  }
}

__global__ void __launch_bounds__(kThreads) qk_norm_rope_kernel(const Params p) {
  const long long w = static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32;
  const long long txt_rows = static_cast<long long>(p.batch) * p.txt.seq;
  if (w < txt_rows) {
    token(p.txt, p, static_cast<int>(w / p.txt.seq), static_cast<int>(w % p.txt.seq));
  } else if (w < txt_rows + static_cast<long long>(p.batch) * p.img.seq) {
    const long long r = w - txt_rows;
    token(p.img, p, static_cast<int>(r / p.img.seq), static_cast<int>(r % p.img.seq));
  }
}

Stream stream(const void* qkv, long long batch, long long row, const void* cos, const void* sin,
              long long table_batch, const void* gain_q, const void* gain_k, int seq,
              int joint0, int q0, int q_rows) {
  return {static_cast<const uint16_t*>(qkv), batch, row, static_cast<const float*>(cos),
          static_cast<const float*>(sin), table_batch, static_cast<const uint16_t*>(gain_q),
          static_cast<const uint16_t*>(gain_k), seq, joint0, q0, q_rows};
}

}  // namespace

// Both streams in one launch.  Per stream: its QKV output and element
// strides of its batch and token rows, its cos / sin tables and their batch
// stride (0: one table for every batch row), its q and k gains, its length,
// its first joint row, its first q row and how many of its tokens have one.
// q is [batch, heads, q_len, 128], k and v [batch, heads, s_t + s_i, 128].
extern "C" int qk_norm_rope_bf16(
    const void* txt_qkv, long long txt_batch, long long txt_row, const void* txt_cos,
    const void* txt_sin, long long txt_table_batch, const void* txt_gain_q,
    const void* txt_gain_k, int txt_seq, int txt_q0, int txt_q_rows,
    const void* img_qkv, long long img_batch, long long img_row, const void* img_cos,
    const void* img_sin, long long img_table_batch, const void* img_gain_q,
    const void* img_gain_k, int img_seq, int img_q0, int img_q_rows,
    void* q, void* k, void* v, int batch, int heads, int q_len, float eps, void* stream_) {
  const Params p{stream(txt_qkv, txt_batch, txt_row, txt_cos, txt_sin, txt_table_batch,
                        txt_gain_q, txt_gain_k, txt_seq, 0, txt_q0, txt_q_rows),
                 stream(img_qkv, img_batch, img_row, img_cos, img_sin, img_table_batch,
                        img_gain_q, img_gain_k, img_seq, txt_seq, img_q0, img_q_rows),
                 static_cast<uint16_t*>(q), static_cast<uint16_t*>(k),
                 static_cast<uint16_t*>(v), batch, heads, txt_seq + img_seq, q_len, eps};
  const long long rows = static_cast<long long>(batch) * (txt_seq + img_seq);
  if (rows == 0) return 0;
  const long long grid = (rows + kWarps - 1) / kWarps;
  qk_norm_rope_kernel<<<static_cast<unsigned>(grid), kThreads, 0,
                        static_cast<cudaStream_t>(stream_)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
