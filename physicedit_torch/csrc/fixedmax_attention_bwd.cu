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
// has l == 0 and P == 0: its gradients are exactly 0.  The clamp is a
// template switch.
//
// What bounds it on an H100: the tensor cores.  Per head it makes five
// products of S_q * S_k * 128 (q'k^T and g v^T in each of the two passes,
// then dS.k, dS^T.q' and P^T.g), 10 * S_q * S_k * 128 FLOP, over the bytes
// of q', k, v, g, out, dq, dk, dv: at the training shape (S = 3,504) some
// 2,400 FLOP per byte, far above the card's ~295 FLOP/byte ridge.
//
// Design: two passes, neither with atomics, so repeated calls give the same
// bits; both on one Hopper loop built from hopper_attention.cuh's primitives
// (TMA maps, an mbarrier ring, wgmma from shared memory and from registers
// with the transpose bit, setmaxnreg).  A block is a producer warpgroup and
// two consumer warpgroups that each own 64 rows of a 128-row "own" tile pair
// (loaded once by TMA) and walk "stream" tile pairs of 64 rows through a
// 4-stage 128-byte-swizzled ring:
//  - dq pass, one block per (128-row q tile, head, batch): own q' and g,
//    stream k and v.  Turn 1: S = q' K^T and dP = g V^T (wgmma m64n64k16,
//    all K-major in shared memory); dS in registers; turn 2: dq += bf16(dS)
//    . K (dS the register A operand, K MN-major through the transpose bit,
//    m64n128k16).  The producer's warp 1 writes each stage's 64-bit
//    key-liveness word (key < S_k and the key mask), as in K1.
//  - dk/dv pass, one block per (128-key tile, head, batch): own k and v,
//    stream q' and g, with warp 1 writing the stage's 1 / max(l, 1e-30) and
//    D rows (0 past S_q) beside them.  Turn 1: S^T = K q'^T and dP^T = V g^T;
//    P^T and dS^T in registers; turn 2: dv += bf16(P^T) . g and dk +=
//    bf16(dS^T) . q', g and q' read MN-major from the same swizzled tiles
//    that turn 1 read K-major.
// The two consumers take turns through two named barriers (ping-pong), so
// one's elementwise work runs under the other's products.  Each stage takes
// two turns: issuing a stage's gradient products together with the next
// stage's score products (as the forward issues P.V with QK^T) ran slower
// in development, and in the dk/dv pass it spills.  64-row stream
// tiles keep the consumer's live registers at dq 64 + S 32 + dP 32 (dq pass)
// and dk 64 + dv 64 + S^T 32 + dP^T 32 (dk/dv pass) under its 232.  Ragged
// S_q and S_k: TMA zero-fills past the ends, and the liveness word, the key
// rows' liveness and the zeroed 1 / l rows keep filled keys and rows out of
// every sum.  p below 2^-126 flushes to 0 (ex2.approx.ftz), as in K1.
#include "hopper_attention.cuh"

using namespace physicedit;
using namespace physicedit::hopper;

namespace {

constexpr float kClamp = 100.f;
constexpr float kLn2 = 0.693147180559945309f;
constexpr int kStream = 64;                          // rows of a stream tile
constexpr int kStreamBytes = kStream * kHeadDim * 2;  // two 64-d boxes of 8 KB
constexpr int kBwdStages = 4;

struct __align__(1024) BwdStorage {
  uint8_t own_a[kTileBytes];                 // q' (dq pass) or k (dk/dv pass), 128 rows
  uint8_t own_b[kTileBytes];                 // g or v
  uint8_t str_a[kBwdStages][kStreamBytes];   // k or q', 64 rows per stage
  uint8_t str_b[kBwdStages][kStreamBytes];   // v or g
  float side[kBwdStages][2][kStream];        // dk/dv pass: the stage's 1 / max(l, 1e-30), D
  uint32_t live[kBwdStages][2];              // dq pass: bit c of word w: key 32 w + c
  uint64_t own_full;
  uint64_t full[kBwdStages], empty[kBwdStages];
};

constexpr int kBwdSmemBytes = static_cast<int>(sizeof(BwdStorage)) + 1024;

__device__ __forceinline__ BwdStorage& bwd_storage() {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = smem_u32(smem_raw);
  return *reinterpret_cast<BwdStorage*>(smem_raw + (((base + 1023u) & ~1023u) - base));
}

// Policy supplies, for one block:
//   int n_tiles;                                     stream tiles to walk (>= 1)
//   void load_own(uint32_t a, uint32_t b, uint64_t* bar);     TMA, 4 boxes
//   void load_stream(uint32_t a, uint32_t b, int j, uint64_t* bar);
//   void write_side(BwdStorage& sm, int s, int j, int lane);  warp 1, per stage
//   void begin(int row, int t);                      per consumer thread
//   void scores(float (&sa)[32], float (&sb)[32], const BwdStorage& sm, int s,
//               uint32_t (&pa)[16], uint32_t (&pb)[16], int t);
//   void fence_acc();  void accumulate(pa, pb, uint32_t ta, uint32_t tb);
//   void epilogue(int row, int t);
// where sa = own_a . str_a^T and sb = own_b . str_b^T (64 x 64 per consumer)
// and row is the own-tile row of the thread's first accumulator row.
template <class Policy>
__device__ __forceinline__ void bwd_mainloop(Policy& pol) {
  BwdStorage& sm = bwd_storage();
  const int wg = threadIdx.x / 128;
  const int n = pol.n_tiles;

  if (threadIdx.x == 0) {
    mbar_init(&sm.own_full, 1);
#pragma unroll
    for (int s = 0; s < kBwdStages; ++s) {
      mbar_init(&sm.full[s], 1 + 32);             // the TMA thread's expect_tx and warp 1
      mbar_init(&sm.empty[s], kConsumerWarps);    // one arrive per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    if (warp == 0 && lane == 0) {
      mbar_expect_tx(&sm.own_full, 2 * kTileBytes);
      pol.load_own(smem_u32(sm.own_a), smem_u32(sm.own_b), &sm.own_full);
      for (int j = 0; j < n; ++j) {
        const int s = j % kBwdStages;
        mbar_wait(&sm.empty[s], ((j / kBwdStages) & 1) ^ 1);
        mbar_expect_tx(&sm.full[s], 2 * kStreamBytes);
        pol.load_stream(smem_u32(sm.str_a[s]), smem_u32(sm.str_b[s]), j, &sm.full[s]);
      }
    } else if (warp == 1) {
      for (int j = 0; j < n; ++j) {
        const int s = j % kBwdStages;
        mbar_wait(&sm.empty[s], ((j / kBwdStages) & 1) ^ 1);
        pol.write_side(sm, s, j, lane);
        mbar_arrive(&sm.full[s]);   // release: this lane's writes are visible to the waiters
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int cw = wg - 1;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int t = lane % 4;
  const int row = cw * 64 + warp * 16 + lane / 4;   // within the own tile
  const int my_bar = 1 + cw, other_bar = 2 - cw;    // named barriers 1, 2
  const uint32_t a_rows = smem_u32(sm.own_a) + cw * 64 * 128;
  const uint32_t b_rows = smem_u32(sm.own_b) + cw * 64 * 128;

  float sa[32], sb[32];
  uint32_t pa[16], pb[16];
  pol.begin(row, t);
  if (cw == 1) named_arrive(1, 256);   // consumer 0 goes first
  mbar_wait(&sm.own_full, 0);

  for (int j = 0; j < n; ++j) {
    const int s = j % kBwdStages;
    const uint32_t ta = smem_u32(sm.str_a[s]), tb = smem_u32(sm.str_b[s]);
    mbar_wait(&sm.full[s], (j / kBwdStages) & 1);
    // turn 1: the two score products
    named_sync(my_bar, 256);
    wgmma_fence();
    qk_product64(sa, a_rows, ta);
    qk_product64(sb, b_rows, tb);
    wgmma_commit();
    named_arrive(other_bar, 256);
    wgmma_wait_all();
    fence_regs(sa);
    fence_regs(sb);
    pol.scores(sa, sb, sm, s, pa, pb, t);
    // turn 2: the gradient products
    named_sync(my_bar, 256);
    pol.fence_acc();
    fence_regs(pa);
    fence_regs(pb);
    wgmma_fence();
    pol.accumulate(pa, pb, ta, tb);
    wgmma_commit();
    // consumer 1's last turn hands over to nobody: consumer 0 has finished
    if (j + 1 < n || cw == 0) named_arrive(other_bar, 256);
    wgmma_wait_all();
    pol.fence_acc();
    __syncwarp();   // every lane has read the stage's side words
    if (lane == 0) mbar_arrive(&sm.empty[s]);
  }
  pol.epilogue(row, t);
}

// Rows r0 and r0 + 8 of a consumer's accumulator, times scale, as bf16 into
// base's [rows, 128]; rows at or past n_rows are not written.
__device__ __forceinline__ void store_scaled(uint16_t* base, int r0, int n_rows,
                                             const float (&acc)[64], float scale, int t) {
  const float(&a)[16][4] = as_rows(acc);
  const int r1 = r0 + 8;
#pragma unroll
  for (int jd = 0; jd < 16; ++jd) {
    const int c = 8 * jd + 2 * t;
    if (r0 < n_rows)
      *reinterpret_cast<uint32_t*>(base + (long)r0 * kHeadDim + c) =
          pack_bf16(a[jd][0] * scale, a[jd][1] * scale);
    if (r1 < n_rows)
      *reinterpret_cast<uint32_t*>(base + (long)r1 * kHeadDim + c) =
          pack_bf16(a[jd][2] * scale, a[jd][3] * scale);
  }
}

// P (times 1 / l) and dS of one score: the same expression in both passes.
template <bool kClampOn>
__device__ __forceinline__ float grad_score(float sig, float dp, bool live, float inv_l,
                                            float d, float* p_out) {
  const float p = live ? ex2_ftz(kClampOn ? fminf(sig, kClamp) : sig) * inv_l : 0.f;
  *p_out = p;
  const float ds = p * (dp - d);
  return (kClampOn && !(sig < kClamp)) ? 0.f : ds;
}

__device__ __forceinline__ void load_pair(uint32_t dst, const CUtensorMap* map, uint64_t* bar,
                                          int row0, int bh, int box_bytes) {
  tma_load_3d(dst, map, bar, 0, row0, bh);
  tma_load_3d(dst + box_bytes, map, bar, 64, row0, bh);
}

// dq pass: own q' (a) and g (b), stream k (a) and v (b).
template <bool kClampOn>
struct DqPolicy {
  const CUtensorMap* qmap;   // 128-row boxes
  const CUtensorMap* gmap;
  const CUtensorMap* kmap;   // 64-row boxes
  const CUtensorMap* vmap;
  const uint8_t* mask;       // this batch row's [S_k] (1 = live), or null
  const float* l;            // this (batch, head)'s [S_q]
  const float* dd;
  uint16_t* dq;              // this (batch, head)'s [S_q, 128]
  int q0, bh, sq, sk, n_tiles;
  float inv_l[2], d[2];      // of the thread's two rows
  float acc[64];

  __device__ void load_own(uint32_t a, uint32_t b, uint64_t* bar) const {
    load_pair(a, qmap, bar, q0, bh, kBoxBytes);
    load_pair(b, gmap, bar, q0, bh, kBoxBytes);
  }
  __device__ void load_stream(uint32_t a, uint32_t b, int j, uint64_t* bar) const {
    load_pair(a, kmap, bar, j * kStream, bh, kBoxBytes / 2);
    load_pair(b, vmap, bar, j * kStream, bh, kBoxBytes / 2);
  }
  __device__ bool live(int key) const { return key < sk && (mask == nullptr || mask[key] != 0); }
  __device__ void write_side(BwdStorage& sm, int s, int j, int lane) const {
    const uint32_t w0 = __ballot_sync(0xffffffffu, live(j * kStream + lane));
    const uint32_t w1 = __ballot_sync(0xffffffffu, live(j * kStream + 32 + lane));
    if (lane == 0) *reinterpret_cast<uint2*>(sm.live[s]) = make_uint2(w0, w1);
  }
  __device__ void begin(int row, int) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = q0 + row + 8 * i;
      inv_l[i] = r < sq ? 1.f / fmaxf(l[r], 1e-30f) : 0.f;
      d[i] = r < sq ? dd[r] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  }
  // sa = S, sb = dP (rows: q, columns: the stage's keys) -> pa = bf16(dS)
  __device__ void scores(float (&sa)[32], const float (&sb)[32], const BwdStorage& sm, int s,
                         uint32_t (&pa)[16], uint32_t (&)[16], int t) const {
    const uint2 word = *reinterpret_cast<const uint2*>(sm.live[s]);
    const uint32_t w[2] = {word.x >> (2 * t), word.y >> (2 * t)};
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = (w[nb / 4] >> (8 * (nb % 4) + (e & 1))) & 1u;
        float p;
        sa[4 * nb + e] = grad_score<kClampOn>(sa[4 * nb + e], sb[4 * nb + e], ok,
                                              inv_l[e >> 1], d[e >> 1], &p);
      }
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) pa[i] = pack_bf16(sa[2 * i], sa[2 * i + 1]);
  }
  __device__ void fence_acc() { fence_regs(acc); }
  __device__ void accumulate(const uint32_t (&pa)[16], const uint32_t (&)[16], uint32_t ta,
                             uint32_t) {
    pv_product64(acc, pa, ta);
  }
  __device__ void epilogue(int row, int t) const {
    store_scaled(dq, q0 + row, sq, acc, kLn2, t);
  }
};

// dk/dv pass: own k (a) and v (b), stream q' (a) and g (b).
template <bool kClampOn>
struct DkvPolicy {
  const CUtensorMap* kmap;   // 128-row boxes
  const CUtensorMap* vmap;
  const CUtensorMap* qmap;   // 64-row boxes
  const CUtensorMap* gmap;
  const uint8_t* mask;
  const float* l;
  const float* dd;
  uint16_t* dk;              // this (batch, head)'s [S_k, 128]
  uint16_t* dv;
  int k0, bh, sq, sk, n_tiles;
  bool key_live[2];          // of the thread's two key rows
  float acc_k[64], acc_v[64];

  __device__ void load_own(uint32_t a, uint32_t b, uint64_t* bar) const {
    load_pair(a, kmap, bar, k0, bh, kBoxBytes);
    load_pair(b, vmap, bar, k0, bh, kBoxBytes);
  }
  __device__ void load_stream(uint32_t a, uint32_t b, int j, uint64_t* bar) const {
    load_pair(a, qmap, bar, j * kStream, bh, kBoxBytes / 2);
    load_pair(b, gmap, bar, j * kStream, bh, kBoxBytes / 2);
  }
  __device__ void write_side(BwdStorage& sm, int s, int j, int lane) const {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = j * kStream + 32 * h + lane;
      sm.side[s][0][32 * h + lane] = r < sq ? 1.f / fmaxf(l[r], 1e-30f) : 0.f;
      sm.side[s][1][32 * h + lane] = r < sq ? dd[r] : 0.f;
    }
  }
  __device__ void begin(int row, int) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int key = k0 + row + 8 * i;
      key_live[i] = key < sk && (mask == nullptr || mask[key] != 0);
    }
#pragma unroll
    for (int i = 0; i < 64; ++i) acc_k[i] = acc_v[i] = 0.f;
  }
  // sa = S^T, sb = dP^T (rows: keys, columns: the stage's q rows) ->
  // pa = bf16(P^T), pb = bf16(dS^T)
  __device__ void scores(float (&sa)[32], float (&sb)[32], const BwdStorage& sm, int s,
                         uint32_t (&pa)[16], uint32_t (&pb)[16], int t) const {
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
      const float2 il = *reinterpret_cast<const float2*>(&sm.side[s][0][8 * nb + 2 * t]);
      const float2 dr = *reinterpret_cast<const float2*>(&sm.side[s][1][8 * nb + 2 * t]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p;
        sb[4 * nb + e] = grad_score<kClampOn>(sa[4 * nb + e], sb[4 * nb + e], key_live[e >> 1],
                                              (e & 1) ? il.y : il.x, (e & 1) ? dr.y : dr.x,
                                              &p);
        sa[4 * nb + e] = p;
      }
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      pa[i] = pack_bf16(sa[2 * i], sa[2 * i + 1]);
      pb[i] = pack_bf16(sb[2 * i], sb[2 * i + 1]);
    }
  }
  __device__ void fence_acc() {
    fence_regs(acc_k);
    fence_regs(acc_v);
  }
  __device__ void accumulate(const uint32_t (&pa)[16], const uint32_t (&pb)[16], uint32_t ta,
                             uint32_t tb) {
    pv_product64(acc_v, pa, tb);   // dv += P^T . g
    pv_product64(acc_k, pb, ta);   // dk += dS^T . q'
  }
  __device__ void epilogue(int row, int t) const {
    store_scaled(dk, k0 + row, sk, acc_k, kLn2, t);
    store_scaled(dv, k0 + row, sk, acc_v, 1.f, t);
  }
};

template <bool kClampOn>
__global__ void __launch_bounds__(kBlockThreads, 1)
fm_bwd_dq_kernel(const __grid_constant__ CUtensorMap qmap,
                 const __grid_constant__ CUtensorMap gmap,
                 const __grid_constant__ CUtensorMap kmap,
                 const __grid_constant__ CUtensorMap vmap, const uint8_t* __restrict__ key_mask,
                 const float* __restrict__ l, const float* __restrict__ dd,
                 uint16_t* __restrict__ dq, int n_heads, int sq, int sk) {
  const int bh = blockIdx.z * n_heads + blockIdx.y;
  DqPolicy<kClampOn> pol{&qmap, &gmap, &kmap, &vmap,
                         key_mask ? key_mask + (long)blockIdx.z * sk : nullptr,
                         l + (long)bh * sq, dd + (long)bh * sq, dq + (long)bh * sq * kHeadDim,
                         (int)blockIdx.x * kTile, bh, sq, sk, (sk + kStream - 1) / kStream};
  bwd_mainloop(pol);
}

template <bool kClampOn>
__global__ void __launch_bounds__(kBlockThreads, 1)
fm_bwd_dkv_kernel(const __grid_constant__ CUtensorMap kmap,
                  const __grid_constant__ CUtensorMap vmap,
                  const __grid_constant__ CUtensorMap qmap,
                  const __grid_constant__ CUtensorMap gmap, const uint8_t* __restrict__ key_mask,
                  const float* __restrict__ l, const float* __restrict__ dd,
                  uint16_t* __restrict__ dk, uint16_t* __restrict__ dv, int n_heads, int sq,
                  int sk) {
  const int bh = blockIdx.z * n_heads + blockIdx.y;
  DkvPolicy<kClampOn> pol{&kmap, &vmap, &qmap, &gmap,
                          key_mask ? key_mask + (long)blockIdx.z * sk : nullptr,
                          l + (long)bh * sq, dd + (long)bh * sq,
                          dk + (long)bh * sk * kHeadDim, dv + (long)bh * sk * kHeadDim,
                          (int)blockIdx.x * kTile, bh, sq, sk, (sq + kStream - 1) / kStream};
  bwd_mainloop(pol);
}

template <bool kClampOn>
int launch(const void* q, const void* k, const void* v, const uint8_t* mask, const void* g,
           const float* l, const float* dd, void* dq, void* dk, void* dv, int batch, int heads,
           int sq, int sk, cudaStream_t stream) {
  const cuuint64_t bn = static_cast<cuuint64_t>(batch) * heads;
  const cuuint64_t qdims[3] = {kHeadDim, static_cast<cuuint64_t>(sq), bn};
  const cuuint64_t kdims[3] = {kHeadDim, static_cast<cuuint64_t>(sk), bn};
  const cuuint64_t qstr[2] = {kHeadDim * 2, static_cast<cuuint64_t>(sq) * kHeadDim * 2};
  const cuuint64_t kstr[2] = {kHeadDim * 2, static_cast<cuuint64_t>(sk) * kHeadDim * 2};
  // own tiles: 128-row boxes; stream tiles: 64-row boxes
  CUtensorMap q_own, g_own, k_str, v_str, k_own, v_own, q_str, g_str;
  if (!make_map(&q_own, q, 3, qdims, qstr, 1) || !make_map(&g_own, g, 3, qdims, qstr, 1) ||
      !make_map(&k_str, k, 3, kdims, kstr, 1, kStream) ||
      !make_map(&v_str, v, 3, kdims, kstr, 1, kStream) ||
      !make_map(&k_own, k, 3, kdims, kstr, 1) || !make_map(&v_own, v, 3, kdims, kstr, 1) ||
      !make_map(&q_str, q, 3, qdims, qstr, 1, kStream) ||
      !make_map(&g_str, g, 3, qdims, qstr, 1, kStream))
    return static_cast<int>(cudaErrorInvalidValue);
  auto dq_kernel = fm_bwd_dq_kernel<kClampOn>;
  auto dkv_kernel = fm_bwd_dkv_kernel<kClampOn>;
  static const cudaError_t attr_q = cudaFuncSetAttribute(
      dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBwdSmemBytes);
  static const cudaError_t attr_kv = cudaFuncSetAttribute(
      dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBwdSmemBytes);
  if (attr_q != cudaSuccess) return static_cast<int>(attr_q);
  if (attr_kv != cudaSuccess) return static_cast<int>(attr_kv);
  const dim3 grid_q((sq + kTile - 1) / kTile, heads, batch);
  dq_kernel<<<grid_q, kBlockThreads, kBwdSmemBytes, stream>>>(
      q_own, g_own, k_str, v_str, mask, l, dd, static_cast<uint16_t*>(dq), heads, sq, sk);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_k((sk + kTile - 1) / kTile, heads, batch);
  dkv_kernel<<<grid_k, kBlockThreads, kBwdSmemBytes, stream>>>(
      k_own, v_own, q_str, g_str, mask, l, dd, static_cast<uint16_t*>(dk),
      static_cast<uint16_t*>(dv), heads, sq, sk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q' and g [B, N, Sq, 128], k and v [B, N, Sk, 128]: bf16, contiguous, 16-byte
// aligned (TMA).  key_mask [B, Sk] uint8 (1 = live) or null; l and D [B, N, Sq]
// fp32.  Writes dq [B, N, Sq, 128], dk and dv [B, N, Sk, 128], bf16.  Launches
// the dq pass, then the dk/dv pass, on the stream; returns cudaGetLastError().
extern "C" int fixedmax_attention_bwd_bf16(const void* q, const void* k, const void* v,
                                           const void* key_mask, const void* g, const void* l,
                                           const void* dd, void* dq, void* dk, void* dv,
                                           int batch, int heads, int sq, int sk, int clamp,
                                           void* stream) {
  if (batch == 0 || heads == 0 || sq == 0) return 0;
  if (sk <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto* mp = static_cast<const uint8_t*>(key_mask);
  const auto* lp = static_cast<const float*>(l);
  const auto* dp = static_cast<const float*>(dd);
  const auto s = static_cast<cudaStream_t>(stream);
  return clamp ? launch<true>(q, k, v, mp, g, lp, dp, dq, dk, dv, batch, heads, sq, sk, s)
               : launch<false>(q, k, v, mp, g, lp, dp, dq, dk, dv, batch, heads, sq, sk, s);
}

// The dynamic shared memory of one block of either pass, for the report
// beside ptxas's.
extern "C" int fixedmax_attention_bwd_smem_bytes() { return kBwdSmemBytes; }
