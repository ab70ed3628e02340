// T4: fixed-max attention with an int8 QK^T, head_dim 128, and the row
// quantize of its q and k.
//
// Replaces tools/proto_attn_int8qk.py::fixedmax_int8qk (body _kernel), the
// Pallas prototype its measurement tool drives, and the XLA ops of its
// wrapper that quantize q and k (the port of both is
// physicedit_torch/tools/proto_attn_int8qk.py).  q and k are quantized per
// row, q = qs * q8 and k = ks * k8 with int8 codes and fp32 scales that carry
// sqrt(log2(e) / sqrt(d)) each; per key:
//     s  = q8 k8^T                                   exact int32
//     sf = fp32(s) * qs[row] * ks[key] + key_bias[b, key]   (each step rounded)
//     p  = exp2(min(sf, 100)),  l += p (fp32)
//     acc += bf16(p) . v (fp32)
// and out = acc / max(l, 1e-30) in bf16: no running max, as in K1.  S_q and
// S_k must be multiples of 64 (the wrapper raises otherwise; JAX leaves the
// rows past its last whole block unwritten).
//
// What bounds it on an H100: the tensor cores.  At B=2, N=24, S=8448 the QK^T
// is 8.8e11 int8 operations (0.443 ms at 1,979 TOP/s) and PV 8.8e11 bf16 FLOP
// (0.887 ms at 989 TFLOP/s): 1.330 ms, against 1.773 for K1's two bf16
// products.  Design (int8qk_hopper_kernel): an Int8QkPolicy on K1's Hopper
// mainloop (hopper_attention.cuh) with Score = int: the Q tile and each K
// tile are one TMA box of 128 rows x 128 bytes (16 KB, half of bf16's two
// boxes), and S = Q K^T is four wgmma m64n128k32 s32.s8.s8 products with
// both operands K-major in shared memory, into the int32 accumulator, whose
// layout is the fp32 one's.  V stays a bf16 tile and PV the loop's bf16
// product with P from registers.  The 128 key scales of a tile (this batch
// and head) and its 128 key biases (this batch) ride the K stage: two bulk
// copies into a 1 KB slot per stage that complete on the stage's full
// barrier (a partial last tile copies only its keys), read in read_stage
// before the warp releases the stage, where each int32 logit becomes its fp32
// sf in place (its bits kept in the int register), so no scale or bias
// register stays live into the softmax.  The softmax clamps, takes exp2 on
// the special-function unit (ex2.approx.ftz), zeroes keys at or past S_k
// (K's TMA zeros give s = 0, not p = 0) through the loop's liveness word,
// sums l per thread and packs P to bf16; the epilogue reduces l over the 4
// threads of a row and divides.  Numerics against the plain version: exp2 is
// ex2.approx (a few fp32 ulps) and fp32 sums run in another order.
//
// The row quantize (int8qk_rowquant_kernel) takes q and k in one launch: a
// half-warp per 128-element row, 8 bf16 (16 bytes) a lane, amax by shuffles,
// s = max(amax / 127, 1e-8) by a true division, codes round(x / s) half to
// even clipped to +-127, and the scale written times sqrt(log2(e) /
// sqrt(d)): the plain version's (rowquant, then the multiply) bits.  It is
// bound by its bytes, 256 read and 128 + 4 written a row.
#include "hopper_attention.cuh"

using namespace physicedit;
namespace hp = physicedit::hopper;

namespace {

constexpr float kClampValue = 100.f;

struct Int8QkPolicy {
  using Score = int;
  // a tile's 128 key scales, then its 128 key biases
  static constexpr uint32_t kExtraKBytes = 2 * hp::kTile * sizeof(float);

  const CUtensorMap* qmap;
  const CUtensorMap* kmap;
  const CUtensorMap* vmap;
  const float* q_scale;   // this (batch, head)'s [S_q]
  const float* k_scale;   // this (batch, head)'s [S_k]
  const float* key_bias;  // this batch row's [S_k]
  uint16_t* out;          // this (batch, head)'s [S_q, 128]
  int q0, bh, sq, sk, n_tiles;
  float qs0, qs1;         // the q scales of the thread's rows (begin)
  float l0, l1;           // row-sum partials of the thread's rows

  __device__ static uint32_t slot(int stage) {
    return hp::extra_smem_u32<hp::SharedStorageI8>() + stage * kExtraKBytes;
  }
  __device__ int keys(int j) const { return min(hp::kTile, sk - j * hp::kTile); }
  __device__ uint32_t extra_k_bytes(int j) const { return 2u * 4u * keys(j); }
  __device__ void load_q(uint32_t dst, uint64_t* bar) const {
    hp::tma_load_3d(dst, qmap, bar, 0, q0, bh);
  }
  __device__ void load_k(uint32_t dst, int j, uint64_t* bar) const {
    hp::tma_load_3d(dst, kmap, bar, 0, j * hp::kTile, bh);
    const uint32_t at = slot(j % hp::kStages);
    const uint32_t bytes = 4u * keys(j);
    hp::bulk_load_1d(at, k_scale + (long)j * hp::kTile, bytes, bar);
    hp::bulk_load_1d(at + kExtraKBytes / 2, key_bias + (long)j * hp::kTile, bytes, bar);
  }
  __device__ void load_v(uint32_t dst, int j, uint64_t* bar) const {
    hp::tma_load_3d(dst, vmap, bar, 0, j * hp::kTile, bh);
    hp::tma_load_3d(dst + hp::kBoxBytes, vmap, bar, 64, j * hp::kTile, bh);
  }
  __device__ bool live(int key) const { return key < sk; }
  __device__ void begin(int row, int) {
    const int r0 = q0 + row, r1 = r0 + 8;
    qs0 = r0 < sq ? q_scale[r0] : 0.f;
    qs1 = r1 < sq ? q_scale[r1] : 0.f;
  }

  // S(j)'s int32 logits -> sf = fp32(s) * qs[row] * ks[key] + bias[key] in
  // place, as fp32 bits, each step rounded (no FMA).  Element 4 nb + e is
  // row g (e < 2) or g + 8, key 8 nb + 2t + (e & 1).  Slot entries past a
  // partial tile's keys hold an earlier tile's values; those keys are not
  // live.
  __device__ void read_stage(int stage, int, int (&s)[64]) const {
    const uint32_t at = slot(stage) + 8 * (threadIdx.x % 4);
#pragma unroll
    for (int nb = 0; nb < 16; ++nb) {
      float k0, k1, b0, b1;
      asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n" : "=f"(k0), "=f"(k1) : "r"(at + 32 * nb));
      asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
                   : "=f"(b0), "=f"(b1) : "r"(at + kExtraKBytes / 2 + 32 * nb));
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = __fmul_rn(__fmul_rn(__int2float_rn(s[4 * nb + e]), e < 2 ? qs0 : qs1),
                                  e & 1 ? k1 : k0);
        s[4 * nb + e] = __float_as_int(__fadd_rn(x, e & 1 ? b1 : b0));
      }
    }
  }

  // sf -> p = exp2(min(sf, 100)), 0 where not live (kTest), the row sums,
  // P packed to bf16: p[2 nb] is row g's pair at keys 8 nb + 2t, + 1 and
  // p[2 nb + 1] row g + 8's.
  template <bool kTest>
  __device__ __forceinline__ void p_tile(const int (&s)[64], uint4 word, uint32_t (&p)[32],
                                         int t) {
    const uint32_t w[4] = {word.x >> (2 * t), word.y >> (2 * t), word.z >> (2 * t),
                           word.w >> (2 * t)};
#pragma unroll
    for (int nb = 0; nb < 16; ++nb) {
      float x[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        x[e] = hp::ex2_ftz(fminf(__int_as_float(s[4 * nb + e]), kClampValue));
        if (kTest && !((w[nb / 4] >> (8 * (nb % 4) + (e & 1))) & 1u)) x[e] = 0.f;
      }
      l0 += x[0] + x[1];
      l1 += x[2] + x[3];
      p[2 * nb] = pack_bf16(x[0], x[1]);
      p[2 * nb + 1] = pack_bf16(x[2], x[3]);
    }
  }

  __device__ void softmax(int (&s)[64], uint4 word, int, float (&)[64], uint32_t (&p)[32], int,
                          int t) {
    if (hp::all_live(word)) p_tile<false>(s, word, p, t);
    else p_tile<true>(s, word, p, t);
  }

  // acc / max(l, 1e-30) (store_rows): a row with every key blocked comes out 0.
  __device__ void epilogue(const float (&o)[64], int row, int t) const {
    const int r0 = q0 + row, r1 = r0 + 8;
    store_rows(out, (long)r0 * kHeadDim, (long)r1 * kHeadDim, r0 < sq, r1 < sq, hp::as_rows(o),
               quad_sum(l0), quad_sum(l1), t);
  }
};

constexpr int kSmem = hp::kSmemBytesI8 + hp::kStages * Int8QkPolicy::kExtraKBytes;

__global__ void __launch_bounds__(hp::kBlockThreads, 1)
int8qk_hopper_kernel(const __grid_constant__ CUtensorMap qmap,
                     const __grid_constant__ CUtensorMap kmap,
                     const __grid_constant__ CUtensorMap vmap, const float* __restrict__ q_scale,
                     const float* __restrict__ k_scale, const float* __restrict__ key_bias,
                     uint16_t* __restrict__ out, int n_heads, int sq, int sk) {
  const int bh = blockIdx.z * n_heads + blockIdx.y;
  Int8QkPolicy pol{&qmap, &kmap, &vmap, q_scale + (long)bh * sq, k_scale + (long)bh * sk,
                   key_bias + (long)blockIdx.z * sk, out + (long)bh * sq * kHeadDim,
                   (int)blockIdx.x * hp::kTile, bh, sq, sk, (sk + hp::kTile - 1) / hp::kTile,
                   0.f, 0.f, 0.f, 0.f};
  hp::attention_mainloop(pol);
}

constexpr int kQuantWarps = 8;

// Rows [0, q_rows) of q and then [0, k_rows) of k, each 128 bf16, two rows a
// warp (a half-warp a row, 8 values a lane: 16-byte loads, so that twice the
// bytes are in flight); codes as int8 rows of 128 bytes, scales times
// half_scale.
__global__ void __launch_bounds__(kQuantWarps * 32)
int8qk_rowquant_kernel(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
                       int8_t* __restrict__ qq, int8_t* __restrict__ kq,
                       float* __restrict__ qs, float* __restrict__ ks, long q_rows, long k_rows,
                       float half_scale) {
  const long w = (long)blockIdx.x * kQuantWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32, half = lane / 16, hl = lane % 16;
  const long rows = q_rows + k_rows;
  if (2 * w >= rows) return;   // the whole warp
  const long row = min(2 * w + half, rows - 1);   // an odd last row: both halves take it
  const bool is_q = row < q_rows;
  const long r = is_q ? row : row - q_rows;
  const uint4 raw = *reinterpret_cast<const uint4*>((is_q ? q : k) + r * kHeadDim + 8 * hl);
  const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
  float x[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(words[i] << 16);
    x[2 * i + 1] = __uint_as_float(words[i] & 0xffff0000u);
  }
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) amax = fmaxf(amax, fabsf(x[i]));
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  const float s = fmaxf(__fdiv_rn(amax, 127.f), 1e-8f);
  uint32_t codes[2] = {0u, 0u};
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int c = min(max(__float2int_rn(__fdiv_rn(x[i], s)), -127), 127);
    codes[i / 4] |= (static_cast<uint32_t>(c) & 0xffu) << (8 * (i % 4));
  }
  *reinterpret_cast<uint2*>((is_q ? qq : kq) + r * kHeadDim + 8 * hl) =
      make_uint2(codes[0], codes[1]);
  if (hl == 0) (is_q ? qs : ks)[r] = __fmul_rn(s, half_scale);
}

}  // namespace

// q/k [B, N, S, 128] int8 codes, v [B, N, Sk, 128] bf16, q_scale [B, N, Sq] and
// k_scale [B, N, Sk] fp32 (each times sqrt(log2(e) / sqrt(128))), key_bias
// [B, Sk] fp32, out [B, N, Sq, 128] bf16; all contiguous and 16-byte aligned
// (TMA, bulk copies); Sq % 64 == 0 and Sk % 64 == 0.
extern "C" int proto_int8qk_attention_bf16(const void* q, const void* k, const void* v,
                                           const void* q_scale, const void* k_scale,
                                           const void* key_bias, void* out, int batch,
                                           int heads, int sq, int sk, void* stream) {
  if (sq % 64 != 0 || sk % 64 != 0 || sk == 0) return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0 || heads == 0 || sq == 0) return 0;
  const cuuint64_t bn = static_cast<cuuint64_t>(batch) * heads;
  const cuuint64_t qdims[3] = {kHeadDim, static_cast<cuuint64_t>(sq), bn};
  const cuuint64_t kdims[3] = {kHeadDim, static_cast<cuuint64_t>(sk), bn};
  const cuuint64_t qstr[2] = {kHeadDim, static_cast<cuuint64_t>(sq) * kHeadDim};
  const cuuint64_t kstr[2] = {kHeadDim, static_cast<cuuint64_t>(sk) * kHeadDim};
  const cuuint64_t vstr[2] = {kHeadDim * 2, static_cast<cuuint64_t>(sk) * kHeadDim * 2};
  CUtensorMap qm, km, vm;
  if (!hp::make_map(&qm, q, 3, qdims, qstr, 1, hp::kTile, CU_TENSOR_MAP_DATA_TYPE_UINT8) ||
      !hp::make_map(&km, k, 3, kdims, kstr, 1, hp::kTile, CU_TENSOR_MAP_DATA_TYPE_UINT8) ||
      !hp::make_map(&vm, v, 3, kdims, vstr, 1))
    return static_cast<int>(cudaErrorInvalidValue);
  static const cudaError_t attr = cudaFuncSetAttribute(
      int8qk_hopper_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((sq + hp::kTile - 1) / hp::kTile, heads, batch);
  int8qk_hopper_kernel<<<grid, hp::kBlockThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      qm, km, vm, static_cast<const float*>(q_scale), static_cast<const float*>(k_scale),
      static_cast<const float*>(key_bias), static_cast<uint16_t*>(out), heads, sq, sk);
  return static_cast<int>(cudaGetLastError());
}

// q [q_rows, 128] and k [k_rows, 128] bf16 (contiguous, 16-byte aligned) ->
// codes qq, kq int8 of the same shapes and scales qs [q_rows], ks [k_rows]
// fp32, each max(amax / 127, 1e-8) times half_scale, in one launch.
extern "C" int proto_int8qk_rowquant(const void* q, const void* k, void* qq, void* kq, void* qs,
                                     void* ks, long q_rows, long k_rows, float half_scale,
                                     void* stream) {
  const long pairs = (q_rows + k_rows + 1) / 2;
  if (pairs == 0) return 0;
  const unsigned blocks = static_cast<unsigned>((pairs + kQuantWarps - 1) / kQuantWarps);
  int8qk_rowquant_kernel<<<blocks, kQuantWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
      static_cast<int8_t*>(qq), static_cast<int8_t*>(kq), static_cast<float*>(qs),
      static_cast<float*>(ks), q_rows, k_rows, half_scale);
  return static_cast<int>(cudaGetLastError());
}

// The dynamic shared memory of the attention kernel's block, for the report
// beside ptxas's.
extern "C" int proto_int8qk_attention_smem_bytes() { return kSmem; }
