// K8: the backward of the DiT's fixed-max joint attention (K1), bf16,
// head_dim 128, on the prescaled q' = q * log2(e) / sqrt(d).
//
// Replaces physicedit_tpu/kernels/flash_attention.py::_fm_bwd_dq_kernel and
// ::_fm_bwd_dkv_kernel (launched from _fm_bwd, the VJP of _fixedmax_diff).
// With l the row sums K1 returned and D = rowsum(g * out) (fp32, formed by
// the wrapper):
//     sig = q' k^T                     (masked keys take no part: P = 0)
//     P   = exp2(min(sig, 100)) / max(l, 1e-30)
//     dS  = P * (g v^T - D),           0 where the clamp bound (sig >= 100)
//     dq' = bf16(dS) . k * ln2,  dk = bf16(dS)^T . q' * ln2,  dv = bf16(P)^T . g
// with fp32 sums and bf16 results.  A query row whose keys are all masked
// has l == 0 and P == 0: its gradients are exactly 0.
//
// What bounds it on an H100: the tensor cores.  Per head it makes five
// products of S_q * S_k * 128 (q'k^T and g v^T in each of the two passes,
// then dS.k, dS^T.q' and P^T.g), 10 * S_q * S_k * 128 FLOP, over the bytes
// of q', k, v, g, out, dq, dk, dv: at the training shape (S near 3,250) some
// 2,400 FLOP per byte, far above the card's ~295 FLOP/byte ridge.  Design:
// two kernels, neither with atomics, both on the bf16 mma.sync m16n8k16
// fragments of mma_bf16.cuh with fp32 accumulators.
//  - dq: one block of 4 warps per (64-row q tile, head, batch).  Each warp
//    keeps its 16 rows of q' and of g as A fragments in registers and walks
//    the keys in tiles of 32 staged in shared memory: S and dP by two
//    products, dS in registers, then dS (its C fragments are the A fragments
//    of the next product) . K into the dq accumulator.
//  - dk/dv: one block per (64-key tile, head, batch), its K and V rows in
//    shared memory; it walks the queries in tiles of 32 (q', g, 1/l and D
//    staged), forms S^T and dP^T, then P^T . g and dS^T . q'.
// Ragged S_q and S_k are masked in the kernels.  Not done yet: TMA, wgmma,
// a multi-stage copy pipeline, one fused pass for dq and dk/dv.
#include "mma_bf16.cuh"

using namespace physicedit;

namespace {

constexpr float kClamp = 100.f;
constexpr float kLn2 = 0.693147180559945309f;
constexpr int kOwn = 64;   // rows a block owns: 4 warps x 16
constexpr int kStep = 32;  // rows of the other side per step
constexpr int kDkvSmem = (2 * kOwn + 2 * kStep) * kRowStride * 2 + 2 * kStep * 4;

// Rows [row0, row0 + ROWS) of a [n_rows, 128] bf16 matrix into smem with
// kRowStride; rows at or past n_rows are zero-filled.
template <int ROWS>
__device__ __forceinline__ void load_rows(uint16_t* smem, const uint16_t* base, int row0,
                                          int n_rows) {
#pragma unroll
  for (int it = 0; it < ROWS * 16 / kThreads; ++it) {
    const int idx = threadIdx.x + it * kThreads;
    const int r = idx >> 4;
    const int c = (idx & 15) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n_rows) {
      val = *reinterpret_cast<const uint4*>(base + (long)(row0 + r) * kHeadDim + c);
    }
    *reinterpret_cast<uint4*>(smem + r * kRowStride + c) = val;
  }
}

// The A fragment of rows [row0, row0 + 16), head-dim chunk kc, from smem.
__device__ __forceinline__ void load_a(uint32_t a[4], const uint16_t* s, int row0, int kc,
                                       int g, int t) {
  const uint16_t* r0 = s + (row0 + g) * kRowStride + kc * 16 + 2 * t;
  const uint16_t* r1 = r0 + 8 * kRowStride;
  a[0] = *reinterpret_cast<const uint32_t*>(r0);
  a[1] = *reinterpret_cast<const uint32_t*>(r1);
  a[2] = *reinterpret_cast<const uint32_t*>(r0 + 8);
  a[3] = *reinterpret_cast<const uint32_t*>(r1 + 8);
}

// s[16 x 8 NJ] = A[16 x 128] . B^T, B the smem rows [0, 8 NJ); A in registers.
template <int NJ>
__device__ __forceinline__ void dot_rows(float s[NJ][4], const uint32_t a[8][4],
                                         const uint16_t* bs, int g, int t) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    const uint16_t* brow = bs + (8 * j + g) * kRowStride + 2 * t;
#pragma unroll
    for (int kc = 0; kc < 8; ++kc) {
      const uint32_t b0 = *reinterpret_cast<const uint32_t*>(brow + kc * 16);
      const uint32_t b1 = *reinterpret_cast<const uint32_t*>(brow + kc * 16 + 8);
      mma_bf16_16816(s[j], a[kc], b0, b1);
    }
  }
}

// The same with A read from smem rows [arow0, arow0 + 16), one chunk at a
// time (fewer registers).
template <int NJ>
__device__ __forceinline__ void dot_rows_smem(float s[NJ][4], const uint16_t* as, int arow0,
                                              const uint16_t* bs, int g, int t) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
  for (int kc = 0; kc < 8; ++kc) {
    uint32_t a[4];
    load_a(a, as, arow0, kc, g, t);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const uint16_t* brow = bs + (8 * j + g) * kRowStride + 2 * t + kc * 16;
      mma_bf16_16816(s[j], a, *reinterpret_cast<const uint32_t*>(brow),
                     *reinterpret_cast<const uint32_t*>(brow + 8));
    }
  }
}

// acc[16 x 128] += bf16(P)[16 x 16 NKC] . B[16 NKC x 128], B the smem rows
// [0, 16 NKC) (the contraction runs over them).
template <int NKC>
__device__ __forceinline__ void acc_rows(float acc[16][4], const float p[2 * NKC][4],
                                         const uint16_t* bs, int g, int t) {
#pragma unroll
  for (int kc = 0; kc < NKC; ++kc) {
    uint32_t pa[4];
    pa[0] = pack_bf16(p[2 * kc][0], p[2 * kc][1]);
    pa[1] = pack_bf16(p[2 * kc][2], p[2 * kc][3]);
    pa[2] = pack_bf16(p[2 * kc + 1][0], p[2 * kc + 1][1]);
    pa[3] = pack_bf16(p[2 * kc + 1][2], p[2 * kc + 1][3]);
    const uint16_t* b0p = bs + (16 * kc + 2 * t) * kRowStride + g;
#pragma unroll
    for (int jd = 0; jd < 16; ++jd) {
      const uint16_t* col = b0p + 8 * jd;
      const uint32_t b0 = pack_raw(col[0], col[kRowStride]);
      const uint32_t b1 = pack_raw(col[8 * kRowStride], col[9 * kRowStride]);
      mma_bf16_16816(acc[jd], pa, b0, b1);
    }
  }
}

// Rows g and g+8 of a warp's accumulator, times scale, as bf16.
__device__ __forceinline__ void store_scaled(uint16_t* out, long off_g, long off_g8, bool live_g,
                                             bool live_g8, const float acc[16][4], float scale,
                                             int t) {
#pragma unroll
  for (int jd = 0; jd < 16; ++jd) {
    const int c = 8 * jd + 2 * t;
    if (live_g)
      *reinterpret_cast<uint32_t*>(out + off_g + c) =
          pack_bf16(acc[jd][0] * scale, acc[jd][1] * scale);
    if (live_g8)
      *reinterpret_cast<uint32_t*>(out + off_g8 + c) =
          pack_bf16(acc[jd][2] * scale, acc[jd][3] * scale);
  }
}

// dS (or P) from a score and its dP: the same expression in both kernels.
__device__ __forceinline__ float grad_score(float sig, float dp, bool live, float inv_l,
                                            float d, int clamp, float* p_out) {
  const float x = clamp ? fminf(sig, kClamp) : sig;
  const float p = live ? exp2f(x) * inv_l : 0.f;
  *p_out = p;
  const float ds = p * (dp - d);
  return (clamp && !(sig < kClamp)) ? 0.f : ds;
}

__global__ void __launch_bounds__(kThreads)
fm_bwd_dq_kernel(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
                 const uint16_t* __restrict__ v, const uint8_t* __restrict__ key_mask,
                 const uint16_t* __restrict__ gr, const float* __restrict__ l,
                 const float* __restrict__ dd, uint16_t* __restrict__ dq, int n_heads, int sq,
                 int sk, int clamp) {
  __shared__ __align__(16) uint16_t ks[kOwn * kRowStride];
  __shared__ __align__(16) uint16_t vs[kOwn * kRowStride];
  __shared__ uint8_t live[kStep];

  const int q0 = blockIdx.x * kOwn;
  const long bh = (long)blockIdx.z * n_heads + blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wr = warp * 16;

  // q' and g rows of the tile through the K / V buffers into registers
  load_rows<kOwn>(ks, q + bh * sq * kHeadDim, q0, sq);
  load_rows<kOwn>(vs, gr + bh * sq * kHeadDim, q0, sq);
  __syncthreads();
  uint32_t qa[8][4], ga[8][4];
#pragma unroll
  for (int kc = 0; kc < 8; ++kc) {
    load_a(qa[kc], ks, wr, kc, g, t);
    load_a(ga[kc], vs, wr, kc, g, t);
  }
  __syncthreads();

  const int rg = q0 + wr + g;
  const int rg8 = rg + 8;
  const float il_g = rg < sq ? 1.f / fmaxf(l[bh * sq + rg], 1e-30f) : 0.f;
  const float il_g8 = rg8 < sq ? 1.f / fmaxf(l[bh * sq + rg8], 1e-30f) : 0.f;
  const float d_g = rg < sq ? dd[bh * sq + rg] : 0.f;
  const float d_g8 = rg8 < sq ? dd[bh * sq + rg8] : 0.f;

  float acc[16][4];
#pragma unroll
  for (int jd = 0; jd < 16; ++jd) acc[jd][0] = acc[jd][1] = acc[jd][2] = acc[jd][3] = 0.f;

  const uint16_t* kb = k + bh * sk * kHeadDim;
  const uint16_t* vb = v + bh * sk * kHeadDim;
  const uint8_t* mb = key_mask ? key_mask + (long)blockIdx.z * sk : nullptr;

  for (int k0 = 0; k0 < sk; k0 += kStep) {
    load_rows<kStep>(ks, kb, k0, sk);
    load_rows<kStep>(vs, vb, k0, sk);
    if (threadIdx.x < kStep) {
      const int key = k0 + threadIdx.x;
      live[threadIdx.x] = key < sk && (mb == nullptr || mb[key] != 0);
    }
    __syncthreads();

    float s[4][4], dp[4][4];
    dot_rows<4>(s, qa, ks, g, t);
    dot_rows<4>(dp, ga, vs, g, t);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool lo = e < 2;
        float p;
        s[j][e] = grad_score(s[j][e], dp[j][e], live[8 * j + 2 * t + (e & 1)],
                             lo ? il_g : il_g8, lo ? d_g : d_g8, clamp, &p);
      }
    }
    acc_rows<2>(acc, s, ks, g, t);
    __syncthreads();
  }

  store_scaled(dq, (bh * sq + rg) * kHeadDim, (bh * sq + rg8) * kHeadDim, rg < sq, rg8 < sq,
               acc, kLn2, t);
}

__global__ void __launch_bounds__(kThreads)
fm_bwd_dkv_kernel(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
                  const uint16_t* __restrict__ v, const uint8_t* __restrict__ key_mask,
                  const uint16_t* __restrict__ gr, const float* __restrict__ l,
                  const float* __restrict__ dd, uint16_t* __restrict__ dk,
                  uint16_t* __restrict__ dv, int n_heads, int sq, int sk, int clamp) {
  extern __shared__ __align__(16) uint16_t smem[];
  uint16_t* ko = smem;                        // [64 keys][128]
  uint16_t* vo = ko + kOwn * kRowStride;      // [64 keys][128]
  uint16_t* qt = vo + kOwn * kRowStride;      // [32 queries][128]
  uint16_t* gt = qt + kStep * kRowStride;     // [32 queries][128]
  float* il = reinterpret_cast<float*>(gt + kStep * kRowStride);  // 1 / max(l, 1e-30)
  float* ds_row = il + kStep;                                      // D

  const int k0 = blockIdx.x * kOwn;
  const long bh = (long)blockIdx.z * n_heads + blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wr = warp * 16;

  load_rows<kOwn>(ko, k + bh * sk * kHeadDim, k0, sk);
  load_rows<kOwn>(vo, v + bh * sk * kHeadDim, k0, sk);
  const uint8_t* mb = key_mask ? key_mask + (long)blockIdx.z * sk : nullptr;
  const int kg = k0 + wr + g;
  const int kg8 = kg + 8;
  const bool live_g = kg < sk && (mb == nullptr || mb[kg] != 0);
  const bool live_g8 = kg8 < sk && (mb == nullptr || mb[kg8] != 0);

  float dk_acc[16][4], dv_acc[16][4];
#pragma unroll
  for (int jd = 0; jd < 16; ++jd) {
    dk_acc[jd][0] = dk_acc[jd][1] = dk_acc[jd][2] = dk_acc[jd][3] = 0.f;
    dv_acc[jd][0] = dv_acc[jd][1] = dv_acc[jd][2] = dv_acc[jd][3] = 0.f;
  }

  const uint16_t* qb = q + bh * sq * kHeadDim;
  const uint16_t* gb = gr + bh * sq * kHeadDim;
  for (int q0 = 0; q0 < sq; q0 += kStep) {
    __syncthreads();  // the previous step is done with qt / gt
    load_rows<kStep>(qt, qb, q0, sq);
    load_rows<kStep>(gt, gb, q0, sq);
    if (threadIdx.x < kStep) {
      const int row = q0 + threadIdx.x;
      il[threadIdx.x] = row < sq ? 1.f / fmaxf(l[bh * sq + row], 1e-30f) : 0.f;
      ds_row[threadIdx.x] = row < sq ? dd[bh * sq + row] : 0.f;
    }
    __syncthreads();

    float st[4][4], dpt[4][4];   // S^T and dP^T: rows are keys, columns queries
    dot_rows_smem<4>(st, ko, wr, qt, g, t);
    dot_rows_smem<4>(dpt, vo, wr, gt, g, t);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = 8 * j + 2 * t + (e & 1);
        float p;
        dpt[j][e] = grad_score(st[j][e], dpt[j][e], e < 2 ? live_g : live_g8, il[qc],
                               ds_row[qc], clamp, &p);
        st[j][e] = p;
      }
    }
    acc_rows<2>(dv_acc, st, gt, g, t);
    acc_rows<2>(dk_acc, dpt, qt, g, t);
  }

  store_scaled(dk, (bh * sk + kg) * kHeadDim, (bh * sk + kg8) * kHeadDim, kg < sk, kg8 < sk,
               dk_acc, kLn2, t);
  store_scaled(dv, (bh * sk + kg) * kHeadDim, (bh * sk + kg8) * kHeadDim, kg < sk, kg8 < sk,
               dv_acc, 1.f, t);
}

}  // namespace

// q' and g [B, N, Sq, 128], k and v [B, N, Sk, 128]: bf16, contiguous.
// key_mask [B, Sk] uint8 (1 = live) or null; l and D [B, N, Sq] fp32.
// Writes dq [B, N, Sq, 128], dk and dv [B, N, Sk, 128], bf16.  Launches the
// dq pass, then the dk/dv pass, on the stream; returns cudaGetLastError().
extern "C" int fixedmax_attention_bwd_bf16(const void* q, const void* k, const void* v,
                                           const void* key_mask, const void* g, const void* l,
                                           const void* dd, void* dq, void* dk, void* dv,
                                           int batch, int heads, int sq, int sk, int clamp,
                                           void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const uint16_t*>(q);
  const auto* kp = static_cast<const uint16_t*>(k);
  const auto* vp = static_cast<const uint16_t*>(v);
  const auto* mp = static_cast<const uint8_t*>(key_mask);
  const auto* gp = static_cast<const uint16_t*>(g);
  const auto* lp = static_cast<const float*>(l);
  const auto* dp = static_cast<const float*>(dd);
  const dim3 grid_q((sq + kOwn - 1) / kOwn, heads, batch);
  fm_bwd_dq_kernel<<<grid_q, kThreads, 0, s>>>(qp, kp, vp, mp, gp, lp, dp,
                                               static_cast<uint16_t*>(dq), heads, sq, sk,
                                               clamp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  static bool smem_set = false;
  if (!smem_set) {
    err = cudaFuncSetAttribute(fm_bwd_dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kDkvSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = true;
  }
  const dim3 grid_k((sk + kOwn - 1) / kOwn, heads, batch);
  fm_bwd_dkv_kernel<<<grid_k, kThreads, kDkvSmem, s>>>(
      qp, kp, vp, mp, gp, lp, dp, static_cast<uint16_t*>(dk), static_cast<uint16_t*>(dv),
      heads, sq, sk, clamp);
  return static_cast<int>(cudaGetLastError());
}
