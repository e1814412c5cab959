// K8: attention backward, of the static-bound forward (K3/K6) and of the
// online-softmax forward (K7).
//
// Replaces the TPU backward kernels of `s3od_tpu/ops/flash_attention.py`,
// both reached from `_bwd_rule` -> `_flash_backward`, the backward half of
// the one `custom_vjp` that serves either forward:
//   K8a `_bwd_fused_kernel` (via `_flash_backward_fused`: dq, dk and dv in
//       one pass, with a full-sequence fp32 dk/dv scratch in VMEM, used
//       while 2 * n_pad * D * 4 <= 6 MB: the 1024^2 ViT path and the
//       MMDiT's LoRA step at (24, 4608, 128)), and
//   K8b `_bwd_dq_kernel` + `_bwd_dkv_kernel` (the split route for longer
//       sequences: the 2048^2 path).
// Both compute the same function; which one the TPU runs is a VMEM rule
// and is not ported. One design serves every length here: two kernels on
// one stream, a dkv kernel that owns keys and loops over query tiles and a
// dq kernel that owns query rows and loops over key tiles. Nothing is
// shared between blocks, so no atomics and no fp32 scratch in device
// memory: every output is one block's sum in a fixed order, bit-identical
// from run to run, like the TPU's sequential grid.
//
// Semantics, kept to the letter (`_bwd_*_kernel`, scale = 1 because the
// caller folds D^-0.5 into q):
//   s = q k^T; keys at or past n_valid get -1e30 added;
//   p = exp(min(s - lse, 0)) — the clamp keeps p <= 1 where the static
//       bound left lse below an out-of-window row max; with K7's lse,
//       the exact log-sum-exp of the row, s - lse <= 0 already and the
//       clamp changes nothing;
//   dp = dO v^T; ds = p * (dp - delta), delta = rowsum(o * dO) in fp32
//       (JAX computes it outside Pallas; here a small pass ahead of the
//       kernels, `bwd_delta_kernel`, in fp32 from the bf16 o and dO);
//   dv = bf16(p)^T dO, dk = bf16(ds)^T q, dq = bf16(ds) k, each summed in
//       fp32 and rounded to bf16 once.
// The exponential is taken in base 2, p = exp2(min(fma(s, log2 e,
// -lse log2 e), 0)): a few fp32 ulps from exp(min(s - lse, 0)), far below
// the bf16 rounding of p and ds.
//
// Bound on the H100: the function needs 5 products of 2 BH N^2 D
// operations (s, dp, dv, dk, dq). At ViT-B, 1024^2, batch 4 (BH = 48,
// N = 4160, D = 64) that is 532 GFLOP, 0.538 ms at 989 TFLOP/s, over
// ~100 MB of inputs and outputs (0.03 ms at 3.35 TB/s); at the MMDiT's
// (24, 4608, 128) 652 GFLOP, 0.660 ms, over 226 MB (0.068 ms): both
// compute-bound on the tensor cores, with 2 BH N^2 exponentials (one in
// each kernel; 1.02e9, 0.261 ms at ~3.9e12/s on the SFU at the MMDiT's
// shape) as the second limit. This split design runs 7 products (s and dp
// in both kernels; 0.923 ms at peak for the MMDiT's shape).
//
// Design, chosen by an explicit dispatch on D in the entry point below.
// Every route starts with `bwd_delta_kernel`, one pass over o and dO in
// place of three PyTorch passes (two casts to fp32, a product, a sum),
// which measured several times slower on the H100 (side experiment).
//   D = 64 (ViT-B and ViT-L training) and D = 128 (the MMDiT's LoRA
//     step): two warp-specialised wgmma kernels on `hopper.cuh`, K7's
//     structure, templated on D. Warpgroup 0 is the producer (one thread
//     issues TMA loads through 3-D (D, N, BH) bf16 maps with the 128-byte
//     swizzle, a D = 128 row as two 64-column atoms, and 2-D (N, BH) fp32
//     maps for lse and delta); the consumer warpgroups each own 64 of the
//     block's rows and take turns issuing their products (a ring of named
//     barriers), so one's exponentials run under the others' products.
//     p is one MUFU.EX2 (`exp2_ftz`), which flushes p < 2^-126 to zero:
//     such a p, and its dS, are below bf16's normal range too. A 4-stage
//     ring lets the producer run ahead.
//     - dkv: 2 consumer warpgroups (384 threads; 24 and 240 registers); a
//       block owns 128 keys (K and V loaded once) and walks all N / 64
//       query tiles (Q, dO, lse and delta of 64 queries a stage). It
//       computes in the transposed orientation: S^T = K Q^T and dP^T =
//       V dO^T by SS wgmma m64n64k16 with the keys as M (K and V as
//       stored are the K-major A operands, Q and dO the K-major B
//       operands); then P^T and dS^T sit in the accumulator layout and
//       feed dV += P^T dO and dK += dS^T Q as RS A fragments (m64nDk16),
//       with dO and Q as stored the MN-major B operands.
//       At D = 64 a turn issues tile j's two SS products with tile j - 1's
//       two RS products (OVERLAP): S^T, dP^T, dK, dV hold 32 fp32 a thread
//       each and P^T, dS^T 16 each, 160 registers. At D = 128 dK and dV
//       hold 64 each, and the overlapped body's 224 (of 240) spilled in
//       ptxas's report (144 bytes); a tile there takes two turns, its
//       S^T, dP^T then its own dV, dK, the fragments replacing S^T and
//       dP^T (192 live): no spill, and faster on the H100 than the
//       overlapped body (`s3od_torch/experiments/k8_d128_shapes.py`).
//       Shared memory 1 KB + K, V (32 KB at D = 64, 64 KB at 128) + 4
//       stages of 16.5 or 32.5 KB + 9 mbarriers: 101,448 and 199,752 B.
//     - dq: a block owns 64 NC query rows (Q and dO loaded once; each
//       thread's two rows of lse and delta read once from global) and
//       walks 64-key tiles of K and V up to n_valid: tiles wholly past
//       n_valid give p = exp(-1e30 ...) = 0 exactly and are skipped. S =
//       Q K^T and dP = dO V^T by SS wgmma m64n64k16 (K and V the K-major
//       B operands), dQ += dS K by RS wgmma with K the MN-major B operand,
//       tile j's S and dP issued with tile j - 1's dQ. Registers: S, dP 32
//       fp32 each, dQ D / 2, dS 16. NC = 3 at D = 64 (512 threads, 160
//       registers; three ran faster than two on the H100); NC = 2 at
//       D = 128 (240 registers: at 160, three warpgroups' 144 spilled 240
//       bytes in ptxas's report and ran slower). Shared memory 115,784 B
//       at D = 64 and 197,704 B at 128.
//     Rows and keys at or past N (N = 4160, 4480 and 16448 are odd
//     multiples of 64, so the last 128- or 192-row block reaches past N):
//     TMA fills q, dO, K and V there with zeros, within the head. The dkv
//     kernel's 64-row query tiles never cross N. In the dq kernel, lse and
//     delta of rows past N load as 0 (a guarded read, never another
//     head's), so p = exp(min(0 - 0, 0)) = 1 there: those rows' dS =
//     1 (0 - 0) = 0 only because dO and V are zero, and they are not
//     stored. Keys past N are past n_valid, so p = 0 for them in both
//     kernels (and their K and V rows are zero). No dq, dk or dv row past
//     N is stored.
//     Why two kernels and not FlashAttention-3's single pass (5 products,
//     dQ summed across key blocks by fp32 atomics and converted by a
//     second pass): the split keeps every output one block's sum in a
//     fixed order, bit-identical from run to run like the TPU's
//     sequential grid; the single pass was not built, so its time is not
//     measured.
//   D = 32 (the committed tiny checkpoints): the first, mma.sync kernels
//     below: dkv, a block of 4 warps owning 64 keys (16 a warp, K and V
//     held as A fragments) over every 64-row query tile, double-buffering
//     Q, dO, lse and delta through cp.async; dq, a block owning 64 query
//     rows over every 64-key tile.
#include <type_traits>

#include "hopper.cuh"

using namespace s3od;
typedef __nv_bfloat16 bf16;

namespace {

constexpr float NEG_INF = -1e30f;

// ---- D = 32: mma.sync ------------------------------------------------------

constexpr int BM = 64, BN = 64, THREADS = 128;

template <int D, int ROWS>
__device__ __forceinline__ void load_tile(bf16 (*dst)[D + 8], const bf16* src, int tid) {
  constexpr int CH = D / 8;  // 16-byte chunks per row
  for (int i = tid; i < ROWS * CH; i += THREADS) {
    const int r = i / CH, cc = (i % CH) * 8;
    cp_async16(&dst[r][cc], src + (size_t)r * D + cc);
  }
}

// 64 fp32 values (256 bytes) of lse and of delta: 16 chunks each.
__device__ __forceinline__ void load_rows(float* sl, float* sd, const float* lse,
                                          const float* delta, int tid) {
  if (tid < 16) {
    cp_async16(sl + tid * 4, lse + tid * 4);
  } else if (tid < 32) {
    cp_async16(sd + (tid - 16) * 4, delta + (tid - 16) * 4);
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ g,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         bf16* __restrict__ dk, bf16* __restrict__ dv, int n, int n_valid) {
  constexpr int LDS = D + 8;
  __shared__ __align__(16) bf16 sQ[2][BM][LDS];
  __shared__ __align__(16) bf16 sG[2][BM][LDS];
  __shared__ __align__(16) float sL[2][BM];
  __shared__ __align__(16) float sD[2][BM];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gr = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.x * BN;
  const size_t base = (size_t)blockIdx.y * n * D;
  const bf16* qb = q + base;
  const bf16* gb = g + base;
  const float* lb = lse + (size_t)blockIdx.y * n;
  const float* db = delta + (size_t)blockIdx.y * n;

  // K and V of this key tile go through the second buffers once, into
  // registers; query tile 0 rides in the same group.
  load_tile<D, BN>(sQ[1], k + base + (size_t)k0 * D, tid);
  load_tile<D, BN>(sG[1], v + base + (size_t)k0 * D, tid);
  load_tile<D, BM>(sQ[0], qb, tid);
  load_tile<D, BM>(sG[0], gb, tid);
  load_rows(sL[0], sD[0], lb, db, tid);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  uint32_t kf[D / 16][4], vf[D / 16][4];
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    load_a_frag(kf[ks], &sQ[1][warp * 16][ks * 16], LDS, lane);
    load_a_frag(vf[ks], &sG[1][warp * 16][ks * 16], LDS, lane);
  }
  __syncthreads();

  // This thread's two key rows; padded keys contribute nothing.
  const bool dead0 = k0 + warp * 16 + gr >= n_valid;
  const bool dead1 = k0 + warp * 16 + gr + 8 >= n_valid;

  float acc_k[D / 8][4], acc_v[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc_k[i][j] = acc_v[i][j] = 0.f;

  const int nqt = n / BM;
  for (int qt = 0; qt < nqt; ++qt) {
    const int s = qt & 1;
    if (qt + 1 < nqt) {
      const size_t off = (size_t)(qt + 1) * BM;
      load_tile<D, BM>(sQ[s ^ 1], qb + off * D, tid);
      load_tile<D, BM>(sG[s ^ 1], gb + off * D, tid);
      load_rows(sL[s ^ 1], sD[s ^ 1], lb + off, db + off, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T: rows are this warp's keys, columns
    // the 64 queries of the tile.
    float st[BM / 8][4], dpt[BM / 8][4];
#pragma unroll
    for (int i = 0; i < BM / 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) st[i][j] = dpt[i][j] = 0.f;
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
#pragma unroll
      for (int np = 0; np < BM / 16; ++np) {
        uint32_t b[4];
        load_b_frag_nk(b, &sQ[s][np * 16][ks * 16], LDS, lane);
        mma_bf16(st[2 * np], kf[ks], b[0], b[1]);
        mma_bf16(st[2 * np + 1], kf[ks], b[2], b[3]);
        load_b_frag_nk(b, &sG[s][np * 16][ks * 16], LDS, lane);
        mma_bf16(dpt[2 * np], vf[ks], b[0], b[1]);
        mma_bf16(dpt[2 * np + 1], vf[ks], b[2], b[3]);
      }
    }

    // p = exp(min(s - lse, 0)) with the key mask; ds = p (dp - delta).
#pragma unroll
    for (int nt = 0; nt < BM / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nt * 8 + 2 * t + (e & 1);
        float x = st[nt][e];
        if (e < 2 ? dead0 : dead1) x += NEG_INF;
        const float p = expf(fminf(x - sL[s][col], 0.f));
        st[nt][e] = p;
        dpt[nt][e] = p * (dpt[nt][e] - sD[s][col]);
      }
    }

    // dV += bf16(P^T) dO and dK += bf16(dS^T) Q: the accumulator fragments
    // of S^T and dS^T are re-packed as A operands (k = query).
#pragma unroll
    for (int kk = 0; kk < BM / 16; ++kk) {
      uint32_t ap[4], ad[4];
      ap[0] = pack_bf16(st[2 * kk][0], st[2 * kk][1]);
      ap[1] = pack_bf16(st[2 * kk][2], st[2 * kk][3]);
      ap[2] = pack_bf16(st[2 * kk + 1][0], st[2 * kk + 1][1]);
      ap[3] = pack_bf16(st[2 * kk + 1][2], st[2 * kk + 1][3]);
      ad[0] = pack_bf16(dpt[2 * kk][0], dpt[2 * kk][1]);
      ad[1] = pack_bf16(dpt[2 * kk][2], dpt[2 * kk][3]);
      ad[2] = pack_bf16(dpt[2 * kk + 1][0], dpt[2 * kk + 1][1]);
      ad[3] = pack_bf16(dpt[2 * kk + 1][2], dpt[2 * kk + 1][3]);
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t b[4];
        load_b_frag_kn(b, &sG[s][kk * 16][dp * 16], LDS, lane);
        mma_bf16(acc_v[2 * dp], ap, b[0], b[1]);
        mma_bf16(acc_v[2 * dp + 1], ap, b[2], b[3]);
        load_b_frag_kn(b, &sQ[s][kk * 16][dp * 16], LDS, lane);
        mma_bf16(acc_k[2 * dp], ad, b[0], b[1]);
        mma_bf16(acc_k[2 * dp + 1], ad, b[2], b[3]);
      }
    }
    __syncthreads();
  }

  const int r0 = k0 + warp * 16 + gr, r1 = r0 + 8;
  bf16* dkb = dk + base;
  bf16* dvb = dv + base;
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
    const int col = nt * 8 + 2 * t;
    *reinterpret_cast<uint32_t*>(dkb + (size_t)r0 * D + col) = pack_bf16(acc_k[nt][0], acc_k[nt][1]);
    *reinterpret_cast<uint32_t*>(dkb + (size_t)r1 * D + col) = pack_bf16(acc_k[nt][2], acc_k[nt][3]);
    *reinterpret_cast<uint32_t*>(dvb + (size_t)r0 * D + col) = pack_bf16(acc_v[nt][0], acc_v[nt][1]);
    *reinterpret_cast<uint32_t*>(dvb + (size_t)r1 * D + col) = pack_bf16(acc_v[nt][2], acc_v[nt][3]);
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ g,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        bf16* __restrict__ dq, int n, int n_valid) {
  constexpr int LDS = D + 8;
  __shared__ __align__(16) bf16 sK[2][BN][LDS];
  __shared__ __align__(16) bf16 sV[2][BN][LDS];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gr = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * BM;
  const size_t base = (size_t)blockIdx.y * n * D;
  const bf16* kb = k + base;
  const bf16* vb = v + base;

  // Q and dO of this query tile go through the second buffers once, into
  // registers; key tile 0 rides in the same group.
  load_tile<D, BM>(sK[1], q + base + (size_t)q0 * D, tid);
  load_tile<D, BM>(sV[1], g + base + (size_t)q0 * D, tid);
  load_tile<D, BN>(sK[0], kb, tid);
  load_tile<D, BN>(sV[0], vb, tid);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  uint32_t qf[D / 16][4], gf[D / 16][4];
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    load_a_frag(qf[ks], &sK[1][warp * 16][ks * 16], LDS, lane);
    load_a_frag(gf[ks], &sV[1][warp * 16][ks * 16], LDS, lane);
  }
  __syncthreads();

  const int r0 = q0 + warp * 16 + gr, r1 = r0 + 8;
  const float* lb = lse + (size_t)blockIdx.y * n;
  const float* db = delta + (size_t)blockIdx.y * n;
  const float lse0 = lb[r0], lse1 = lb[r1];
  const float dl0 = db[r0], dl1 = db[r1];

  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  const int nkt = n / BN;
  for (int kt = 0; kt < nkt; ++kt) {
    const int s = kt & 1;
    if (kt + 1 < nkt) {
      const size_t off = (size_t)(kt + 1) * BN * D;
      load_tile<D, BN>(sK[s ^ 1], kb + off, tid);
      load_tile<D, BN>(sV[s ^ 1], vb + off, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // S = Q K^T and dP = dO V^T for this warp's 16 rows x 64 keys.
    float sc[BN / 8][4], dp[BN / 8][4];
#pragma unroll
    for (int i = 0; i < BN / 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = dp[i][j] = 0.f;
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
#pragma unroll
      for (int np = 0; np < BN / 16; ++np) {
        uint32_t b[4];
        load_b_frag_nk(b, &sK[s][np * 16][ks * 16], LDS, lane);
        mma_bf16(sc[2 * np], qf[ks], b[0], b[1]);
        mma_bf16(sc[2 * np + 1], qf[ks], b[2], b[3]);
        load_b_frag_nk(b, &sV[s][np * 16][ks * 16], LDS, lane);
        mma_bf16(dp[2 * np], gf[ks], b[0], b[1]);
        mma_bf16(dp[2 * np + 1], gf[ks], b[2], b[3]);
      }
    }

    // ds = exp(min(s - lse, 0)) (dp - delta), padded keys masked.
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = kt * BN + nt * 8 + 2 * t + (e & 1);
        float x = sc[nt][e];
        if (col >= n_valid) x += NEG_INF;
        const float p = expf(fminf(x - (e < 2 ? lse0 : lse1), 0.f));
        sc[nt][e] = p * (dp[nt][e] - (e < 2 ? dl0 : dl1));
      }
    }

    // dQ += bf16(dS) K
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(sc[2 * kk][0], sc[2 * kk][1]);
      a[1] = pack_bf16(sc[2 * kk][2], sc[2 * kk][3]);
      a[2] = pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]);
      a[3] = pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3]);
#pragma unroll
      for (int dd = 0; dd < D / 16; ++dd) {
        uint32_t b[4];
        load_b_frag_kn(b, &sK[s][kk * 16][dd * 16], LDS, lane);
        mma_bf16(acc[2 * dd], a, b[0], b[1]);
        mma_bf16(acc[2 * dd + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();
  }

  bf16* dqb = dq + base;
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
    const int col = nt * 8 + 2 * t;
    *reinterpret_cast<uint32_t*>(dqb + (size_t)r0 * D + col) = pack_bf16(acc[nt][0], acc[nt][1]);
    *reinterpret_cast<uint32_t*>(dqb + (size_t)r1 * D + col) = pack_bf16(acc[nt][2], acc[nt][3]);
  }
}

template <int D>
int launch_mma(const bf16* q, const bf16* k, const bf16* v, const bf16* g, const float* lse,
               const float* delta, bf16* dq, bf16* dk, bf16* dv, int bh, int n, int n_valid,
               cudaStream_t st) {
  dim3 grid(n / BM, bh);
  flash_bwd_dkv_kernel<D><<<grid, THREADS, 0, st>>>(q, k, v, g, lse, delta, dk, dv, n, n_valid);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dq_kernel<D><<<grid, THREADS, 0, st>>>(q, k, v, g, lse, delta, dq, n, n_valid);
  return static_cast<int>(cudaGetLastError());
}

// ---- D = 64 and 128: TMA + wgmma, warp-specialised -------------------------

namespace wg {

using namespace s3od::hopper;

constexpr int T = 64;  // rows of a streamed tile: queries (dkv), keys (dq)
constexpr int STAGES = 4;
constexpr int TATOM = T * 64;  // elements of a 64-row, 64-column swizzle atom (8 KB)
constexpr float LOG2E = 1.4426950408889634f;

// 1024 bytes of alignment slack; the block's two resident tiles, 64 NC rows
// each (K and V in dkv, Q and dO in dq); the ring; 1 + 2 STAGES mbarriers.
template <int D, int NC>
constexpr int dkv_smem() {
  return 1024 + 2 * 64 * NC * D * 2 + STAGES * (2 * T * D * 2 + 2 * T * 4) + (1 + 2 * STAGES) * 8;
}
template <int D, int NC>
constexpr int dq_smem() {
  return 1024 + 2 * 64 * NC * D * 2 + STAGES * 2 * T * D * 2 + (1 + 2 * STAGES) * 8;
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024 - (smem_addr(p) & 1023)) & 1023);
}

// acc (64 x 64) = A B^T over D: A the warpgroup's 64 rows, B a 64-row
// tile, both as stored (K-major), D / 64 atoms side by side `a_atom` and
// `b_atom` elements apart.
template <int D>
__device__ __forceinline__ void mma_abt(float (&acc)[32], const bf16* a, int a_atom, const bf16* b,
                                        int b_atom) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    WgmmaSS<64>::mma(acc, desc_sw128(a + (kk / 4) * a_atom + (kk % 4) * 16),
                     desc_sw128(b + (kk / 4) * b_atom + (kk % 4) * 16), kk > 0);
}

// acc (64 x D) += A B over 64 rows of B: A the bf16 fragments in
// registers, B a 64-row tile as stored (MN-major, its atoms TATOM apart).
template <int D>
__device__ __forceinline__ void mma_ab(float (&acc)[D / 2], const uint32_t (&a)[4][4],
                                       const bf16* b) {
#pragma unroll
  for (int kk = 0; kk < T / 16; ++kk)
    WgmmaRS<D>::mma(acc, a[kk], desc_sw128(b + kk * 16 * 64, TATOM * 2), 1);
}

// Stores this thread's part of a 64 x D fp32 accumulator (rows r0 and
// r0 + 8) as bf16 rows of `out`, rows at or past n skipped.
template <int D>
__device__ __forceinline__ void store_rows(bf16* out, const float (&acc)[D / 2], int r0, int quad,
                                           int n) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = 8 * j + 2 * quad;
    if (r0 < n)
      *reinterpret_cast<uint32_t*>(out + (size_t)r0 * D + col) = pack_bf16(acc[4 * j], acc[4 * j + 1]);
    if (r0 + 8 < n)
      *reinterpret_cast<uint32_t*>(out + (size_t)(r0 + 8) * D + col) =
          pack_bf16(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

// OVERLAP: a turn issues query tile qt's S^T and dP^T with tile qt - 1's
// dV and dK (S^T, dP^T, dK, dV and both fragments live at once); else a
// tile takes two turns, its dV and dK after its own S^T and dP^T, and the
// fragments replace S^T and dP^T.
template <int D, int NC, bool OVERLAP>
__global__ void __launch_bounds__(ws_threads(NC), 1)
    bwd_dkv_kernel(const __grid_constant__ CUtensorMap map_k,  // boxes of 64 NC rows
                   const __grid_constant__ CUtensorMap map_v,
                   const __grid_constant__ CUtensorMap map_q,  // boxes of 64 rows
                   const __grid_constant__ CUtensorMap map_g,
                   const __grid_constant__ CUtensorMap map_l,  // fp32, boxes of 64
                   const __grid_constant__ CUtensorMap map_d, bf16* __restrict__ dk,
                   bf16* __restrict__ dv, int n, int n_valid) {
  constexpr int ATOMS = D / 64, BLOCK = 64 * NC;
  constexpr int KATOM = BLOCK * 64;  // elements of one K or V atom
  constexpr int TILE = ATOMS * TATOM;
  extern __shared__ unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(align1024(smem_raw));  // [ATOMS][BLOCK][64]
  bf16* sV = sK + ATOMS * KATOM;
  bf16* sQ = sV + ATOMS * KATOM;   // [STAGES][ATOMS][64][64]
  bf16* sG = sQ + STAGES * TILE;   // [STAGES][ATOMS][64][64]
  float* sL = reinterpret_cast<float*>(sG + STAGES * TILE);  // [STAGES][64]
  float* sD = sL + STAGES * T;                               // [STAGES][64]
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(sD + STAGES * T);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + STAGES;

  const int bh = blockIdx.y, k0 = blockIdx.x * BLOCK;
  const int nqt = n / T;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NC * 128);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wgi = threadIdx.x / 128;
  if (wgi == 0) {
    setmaxnreg_dec<ws_producer_regs(NC)>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(kv_full, 2 * BLOCK * D * 2);
#pragma unroll
      for (int a = 0; a < ATOMS; ++a) {
        tma_load_3d(sK + a * KATOM, &map_k, kv_full, a * 64, k0, bh);
        tma_load_3d(sV + a * KATOM, &map_v, kv_full, a * 64, k0, bh);
      }
      for (int qt = 0; qt < nqt; ++qt) {
        const int s = qt % STAGES, ph = (qt / STAGES) & 1;
        mbar_wait(&empty[s], ph ^ 1);
        mbar_expect_tx(&full[s], 2 * TILE * 2 + 2 * T * 4);
#pragma unroll
        for (int a = 0; a < ATOMS; ++a) {
          tma_load_3d(sQ + s * TILE + a * TATOM, &map_q, &full[s], a * 64, qt * T, bh);
          tma_load_3d(sG + s * TILE + a * TATOM, &map_g, &full[s], a * 64, qt * T, bh);
        }
        tma_load_2d(sL + s * T, &map_l, &full[s], qt * T, bh);
        tma_load_2d(sD + s * T, &map_d, &full[s], qt * T, bh);
      }
    }
  } else {
    setmaxnreg_inc<ws_consumer_regs(NC)>();
    const int half = wgi - 1, t = threadIdx.x - 128 * wgi, quad = t & 3;
    // This thread's two keys (rows of S^T); keys at or past n_valid get
    // the bias -1e30, so p = 0 for them.
    const int r0 = k0 + half * 64 + (t >> 5) * 16 + ((t & 31) >> 2);
    const bool any_dead = r0 + 8 >= n_valid;
    const float bias0 = r0 >= n_valid ? NEG_INF : 0.f, bias1 = r0 + 8 >= n_valid ? NEG_INF : 0.f;
    const bf16* kh = sK + half * 64 * 64;  // this warpgroup's rows of each atom
    const bf16* vh = sV + half * 64 * 64;

    float st[32], dpt[32], dka[D / 2], dva[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;
    uint32_t pa[4][4], da[4][4];  // bf16 P^T and dS^T

    auto issue_sd = [&](int qt) {  // S^T = K Q^T, dP^T = V dO^T
      const int s = qt % STAGES;
      mma_abt<D>(st, kh, KATOM, sQ + s * TILE, TATOM);
      mma_abt<D>(dpt, vh, KATOM, sG + s * TILE, TATOM);
      wgmma_commit();
    };
    auto issue_kv = [&](int qt) {  // dV += P^T dO, dK += dS^T Q
      const int s = qt % STAGES;
      mma_ab<D>(dva, pa, sG + s * TILE);
      mma_ab<D>(dka, da, sQ + s * TILE);
      wgmma_commit();
    };
    // P^T and dS^T of query tile qt in place; lse and delta are per
    // column (query).
    auto grads = [&](int qt) {
      const int s = qt % STAGES;
      const float* ls = sL + s * T;
      const float* ds = sD + s * T;
      if (any_dead) {
#pragma unroll
        for (int j = 0; j < T / 8; ++j) {
          st[4 * j] += bias0;
          st[4 * j + 1] += bias0;
          st[4 * j + 2] += bias1;
          st[4 * j + 3] += bias1;
        }
      }
#pragma unroll
      for (int j = 0; j < T / 8; ++j) {
        const int c = 8 * j + 2 * quad;
        const float2 l2 = *reinterpret_cast<const float2*>(ls + c);
        const float2 d2 = *reinterpret_cast<const float2*>(ds + c);
        const float nl[2] = {-l2.x * LOG2E, -l2.y * LOG2E}, dl[2] = {d2.x, d2.y};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2_ftz(fminf(fmaf(st[4 * j + e], LOG2E, nl[e & 1]), 0.f));
          st[4 * j + e] = p;
          dpt[4 * j + e] = p * (dpt[4 * j + e] - dl[e & 1]);
        }
      }
      pack_a(pa, st);
      pack_a(da, dpt);
    };
    // S^T and dP^T of tile qt in one turn, then its gradients.
    auto sd_turn = [&](int qt) {
      mbar_wait(&full[qt % STAGES], (qt / STAGES) & 1);
      turn_begin(half);
      wgmma_fence();
      issue_sd(qt);
      turn_end<NC>(half, false);
      wgmma_wait<0>();
      fence_regs(st);
      fence_regs(dpt);
      grads(qt);
    };
    // dV and dK of tile qt in one turn (the block's last when `last`).
    auto kv_turn = [&](int qt, bool last) {
      turn_begin(half);
      fence_regs(dva);
      fence_regs(dka);
      fence_regs(pa);
      fence_regs(da);
      wgmma_fence();
      issue_kv(qt);
      turn_end<NC>(half, last);
      wgmma_wait<0>();
      fence_regs(dva);
      fence_regs(dka);
      fence_regs(pa);
      fence_regs(da);
    };

    mbar_wait(kv_full, 0);
    turns_open<NC>(half);
    if constexpr (OVERLAP) {
      // Query tile 0: S^T and dP^T only.
      sd_turn(0);
      // Tiles 1..: S^T, dP^T of qt with dV, dK of qt - 1.
      for (int qt = 1; qt < nqt; ++qt) {
        mbar_wait(&full[qt % STAGES], (qt / STAGES) & 1);
        turn_begin(half);
        fence_regs(dva);
        fence_regs(dka);
        fence_regs(pa);
        fence_regs(da);
        wgmma_fence();
        issue_sd(qt);
        issue_kv(qt - 1);
        turn_end<NC>(half, false);
        wgmma_wait<0>();
        fence_regs(st);
        fence_regs(dpt);
        fence_regs(dva);
        fence_regs(dka);
        fence_regs(pa);
        fence_regs(da);  // tile qt - 1's fragments stay until its products are done
        mbar_arrive(&empty[(qt - 1) % STAGES]);
        grads(qt);
      }
      // The last tile's dV and dK.
      kv_turn(nqt - 1, true);
    } else {
      for (int qt = 0; qt < nqt; ++qt) {
        sd_turn(qt);
        kv_turn(qt, qt == nqt - 1);
        mbar_arrive(&empty[qt % STAGES]);
      }
    }

    store_rows<D>(dk + (size_t)bh * n * D, dka, r0, quad, n);
    store_rows<D>(dv + (size_t)bh * n * D, dva, r0, quad, n);
  }
}

template <int D, int NC>
__global__ void __launch_bounds__(ws_threads(NC), 1)
    bwd_dq_kernel(const __grid_constant__ CUtensorMap map_q,  // boxes of 64 NC rows
                  const __grid_constant__ CUtensorMap map_g,
                  const __grid_constant__ CUtensorMap map_k,  // boxes of 64 rows
                  const __grid_constant__ CUtensorMap map_v, const float* __restrict__ lse,
                  const float* __restrict__ delta, bf16* __restrict__ dq, int n, int n_valid) {
  constexpr int ATOMS = D / 64, ROWS = 64 * NC;
  constexpr int QATOM = ROWS * 64;  // elements of one Q or dO atom
  constexpr int TILE = ATOMS * TATOM;
  extern __shared__ unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(align1024(smem_raw));  // [ATOMS][ROWS][64]
  bf16* sG = sQ + ATOMS * QATOM;
  bf16* sK = sG + ATOMS * QATOM;   // [STAGES][ATOMS][64][64]
  bf16* sV = sK + STAGES * TILE;   // [STAGES][ATOMS][64][64]
  uint64_t* qg_full = reinterpret_cast<uint64_t*>(sV + STAGES * TILE);
  uint64_t* full = qg_full + 1;
  uint64_t* empty = full + STAGES;

  const int bh = blockIdx.y, q0 = blockIdx.x * ROWS;
  const int nkt = (n_valid + T - 1) / T;  // tiles wholly past n_valid add exact zeros
  const int edge_tile = n_valid / T;      // the first tile holding a key at or past n_valid

  if (threadIdx.x == 0) {
    mbar_init(qg_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NC * 128);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wgi = threadIdx.x / 128;
  if (wgi == 0) {
    setmaxnreg_dec<ws_producer_regs(NC)>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(qg_full, 2 * ROWS * D * 2);
#pragma unroll
      for (int a = 0; a < ATOMS; ++a) {
        tma_load_3d(sQ + a * QATOM, &map_q, qg_full, a * 64, q0, bh);
        tma_load_3d(sG + a * QATOM, &map_g, qg_full, a * 64, q0, bh);
      }
      for (int kt = 0; kt < nkt; ++kt) {
        const int s = kt % STAGES, ph = (kt / STAGES) & 1;
        mbar_wait(&empty[s], ph ^ 1);
        mbar_expect_tx(&full[s], 2 * TILE * 2);
#pragma unroll
        for (int a = 0; a < ATOMS; ++a) {
          tma_load_3d(sK + s * TILE + a * TATOM, &map_k, &full[s], a * 64, kt * T, bh);
          tma_load_3d(sV + s * TILE + a * TATOM, &map_v, &full[s], a * 64, kt * T, bh);
        }
      }
    }
  } else {
    setmaxnreg_inc<ws_consumer_regs(NC)>();
    const int half = wgi - 1, t = threadIdx.x - 128 * wgi, quad = t & 3;
    const int r0 = q0 + half * 64 + (t >> 5) * 16 + ((t & 31) >> 2), r1 = r0 + 8;
    // lse and delta of this thread's two rows; 0 past N (those rows are
    // zeros of Q and dO, and are not stored).
    const float* lb = lse + (size_t)bh * n;
    const float* db = delta + (size_t)bh * n;
    const float nl0 = r0 < n ? -lb[r0] * LOG2E : 0.f, nl1 = r1 < n ? -lb[r1] * LOG2E : 0.f;
    const float dl0 = r0 < n ? db[r0] : 0.f, dl1 = r1 < n ? db[r1] : 0.f;
    const bf16* qh = sQ + half * 64 * 64;  // this warpgroup's rows of each atom
    const bf16* gh = sG + half * 64 * 64;

    float sa[32], dpa[32], dqa[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dqa[i] = 0.f;
    uint32_t da[4][4];  // bf16 dS of the previous tile

    auto issue_sd = [&](int kt) {  // S = Q K^T, dP = dO V^T
      const int s = kt % STAGES;
      mma_abt<D>(sa, qh, QATOM, sK + s * TILE, TATOM);
      mma_abt<D>(dpa, gh, QATOM, sV + s * TILE, TATOM);
      wgmma_commit();
    };
    auto issue_dq = [&](int kt) {  // dQ += dS K
      mma_ab<D>(dqa, da, sK + (kt % STAGES) * TILE);
      wgmma_commit();
    };
    // dS of key tile kt in place of S. EDGE: the tile holds a key at or
    // past n_valid, so the key mask is tested.
    auto grads = [&](auto edge, int kt) {
      constexpr bool EDGE = decltype(edge)::value;
#pragma unroll
      for (int j = 0; j < T / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = sa[4 * j + e];
          if (EDGE && kt * T + 8 * j + 2 * quad + (e & 1) >= n_valid) x += NEG_INF;
          const float p = exp2_ftz(fminf(fmaf(x, LOG2E, e < 2 ? nl0 : nl1), 0.f));
          sa[4 * j + e] = p * (dpa[4 * j + e] - (e < 2 ? dl0 : dl1));
        }
      }
      pack_a(da, sa);
    };
    auto grads_tile = [&](int kt) {
      if (kt >= edge_tile)
        grads(std::true_type(), kt);
      else
        grads(std::false_type(), kt);
    };

    mbar_wait(qg_full, 0);
    turns_open<NC>(half);
    // Key tile 0: S and dP only.
    mbar_wait(&full[0], 0);
    turn_begin(half);
    wgmma_fence();
    issue_sd(0);
    turn_end<NC>(half, false);
    wgmma_wait<0>();
    fence_regs(sa);
    fence_regs(dpa);
    grads_tile(0);
    // Tiles 1..: S, dP of kt with dQ of kt - 1.
    for (int kt = 1; kt < nkt; ++kt) {
      mbar_wait(&full[kt % STAGES], (kt / STAGES) & 1);
      turn_begin(half);
      fence_regs(dqa);
      fence_regs(da);
      wgmma_fence();
      issue_sd(kt);
      issue_dq(kt - 1);
      turn_end<NC>(half, false);
      wgmma_wait<0>();
      fence_regs(sa);
      fence_regs(dpa);
      fence_regs(dqa);
      fence_regs(da);
      mbar_arrive(&empty[(kt - 1) % STAGES]);
      grads_tile(kt);
    }
    // The last tile's dQ.
    turn_begin(half);
    fence_regs(dqa);
    fence_regs(da);
    wgmma_fence();
    issue_dq(nkt - 1);
    turn_end<NC>(half, true);
    wgmma_wait<0>();
    fence_regs(dqa);

    store_rows<D>(dq + (size_t)bh * n * D, dqa, r0, quad, n);
  }
}

// The two kernels at head dim D: the dkv kernel with DKV_NC consumer
// warpgroups (OVERLAP as above), the dq kernel with DQ_NC.
template <int D, int DKV_NC, int DQ_NC, bool OVERLAP>
int launch_wgmma(const bf16* q, const bf16* k, const bf16* v, const bf16* g, const float* lse,
                 const float* delta, bf16* dq, bf16* dk, bf16* dv, int bh, int n, int n_valid,
                 cudaStream_t st) {
  // bf16 (D, N, BH) maps in boxes of 64 columns and 64 DQ_NC rows (Q, dO
  // for dq), 64 DKV_NC (K, V for dkv) and 64 (the streamed tiles); fp32
  // (N, BH) maps of lse and delta in boxes of 64.
  const uint64_t dims[3] = {(uint64_t)D, (uint64_t)n, (uint64_t)bh};
  const uint64_t strides[2] = {(uint64_t)D * 2, (uint64_t)n * D * 2};
  const uint32_t box_kv[3] = {64, 64 * DKV_NC, 1}, box_qg[3] = {64, 64 * DQ_NC, 1},
                 box_tile[3] = {64, T, 1};
  const uint64_t dims_r[2] = {(uint64_t)n, (uint64_t)bh};
  const uint64_t strides_r[1] = {(uint64_t)n * 4};
  const uint32_t box_r[2] = {T, 1};
  const void* rows[4] = {q, g, k, v};
  CUtensorMap blk[4], tile[4], map_l, map_d;  // q, g, k, v
  int err = 0;
  for (int i = 0; i < 4 && !err; ++i) {
    err = encode_bf16_map(&blk[i], rows[i], 3, dims, strides, i < 2 ? box_qg : box_kv);
    if (!err) err = encode_bf16_map(&tile[i], rows[i], 3, dims, strides, box_tile);
  }
  if (!err) err = encode_f32_map(&map_l, lse, 2, dims_r, strides_r, box_r);
  if (!err) err = encode_f32_map(&map_d, delta, 2, dims_r, strides_r, box_r);
  if (err) return err;
  constexpr int smem_kv = dkv_smem<D, DKV_NC>(), smem_q = dq_smem<D, DQ_NC>();
  static_assert(smem_kv <= 232448 && smem_q <= 232448, "over a block's shared memory");
  auto* dkv_kernel = bwd_dkv_kernel<D, DKV_NC, OVERLAP>;
  auto* dq_kernel = bwd_dq_kernel<D, DQ_NC>;
  cudaError_t e = cudaFuncSetAttribute(dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_kv);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_q);
  if (e != cudaSuccess) return static_cast<int>(e);
  dkv_kernel<<<dim3((n + 64 * DKV_NC - 1) / (64 * DKV_NC), bh), ws_threads(DKV_NC), smem_kv, st>>>(
      blk[2], blk[3], tile[0], tile[1], map_l, map_d, dk, dv, n, n_valid);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  dq_kernel<<<dim3((n + 64 * DQ_NC - 1) / (64 * DQ_NC), bh), ws_threads(DQ_NC), smem_q, st>>>(
      blk[0], blk[1], tile[2], tile[3], lse, delta, dq, n, n_valid);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wg

// ---- delta = rowsum(o * dO) ------------------------------------------------

// One pass ahead of either route: each row of o and dO (D bf16, D / 8
// chunks of 16 bytes) is read by D / 8 threads, whose fp32 partial sums
// are joined by shuffles.
template <int D>
__global__ void __launch_bounds__(256)
    bwd_delta_kernel(const bf16* __restrict__ o, const bf16* __restrict__ g,
                     float* __restrict__ delta, size_t rows) {
  constexpr int PER_ROW = D / 8;
  const size_t i = (size_t)blockIdx.x * 256 + threadIdx.x, row = i / PER_ROW;
  float s = 0.f;
  if (row < rows) {
    const uint4 a = reinterpret_cast<const uint4*>(o)[i];
    const uint4 b = reinterpret_cast<const uint4*>(g)[i];
    const __nv_bfloat162* pa = reinterpret_cast<const __nv_bfloat162*>(&a);
    const __nv_bfloat162* pb = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 fa = __bfloat1622float2(pa[j]), fb = __bfloat1622float2(pb[j]);
      s = fmaf(fa.x, fb.x, s);
      s = fmaf(fa.y, fb.y, s);
    }
  }
#pragma unroll
  for (int off = PER_ROW / 2; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffff, s, off);
  if (row < rows && i % PER_ROW == 0) delta[row] = s;
}

template <int D>
int launch_delta(const bf16* o, const bf16* g, float* delta, int bh, int n, cudaStream_t st) {
  const size_t rows = (size_t)bh * n, chunks = rows * (D / 8);
  bwd_delta_kernel<D><<<(unsigned)((chunks + 255) / 256), 256, 0, st>>>(o, g, delta, rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, o, g (the output's cotangent), dq, dk, dv: (bh, n, d) bf16; lse:
// (bh, n) fp32; delta: (bh, n) fp32 scratch, written here; all 16-byte
// aligned. n a multiple of 64, d in {32, 64, 128}, 0 < n_valid <= n (checked
// by the Python wrapper). D = 64 and 128 take the wgmma kernels, D = 32 the
// mma.sync kernels; all after the delta pass.
extern "C" int s3od_flash_attention_bwd(const void* q, const void* k, const void* v,
                                        const void* o, const void* g, const void* lse,
                                        void* delta, void* dq, void* dk, void* dv, int bh,
                                        int n, int d, int n_valid, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0 || n % 64 || n_valid <= 0 || n_valid > n || (d != 128 && d != 64 && d != 32))
    return static_cast<int>(cudaErrorInvalidValue);
  const bf16* qq = static_cast<const bf16*>(q);
  const bf16* kk = static_cast<const bf16*>(k);
  const bf16* vv = static_cast<const bf16*>(v);
  const bf16* oo = static_cast<const bf16*>(o);
  const bf16* gg = static_cast<const bf16*>(g);
  const float* ll = static_cast<const float*>(lse);
  float* dd = static_cast<float*>(delta);
  bf16* oq = static_cast<bf16*>(dq);
  bf16* ok = static_cast<bf16*>(dk);
  bf16* ov = static_cast<bf16*>(dv);
  if (d == 128) {
    const int err = launch_delta<128>(oo, gg, dd, bh, n, st);
    return err ? err
               : wg::launch_wgmma<128, 2, 2, false>(qq, kk, vv, gg, ll, dd, oq, ok, ov, bh, n,
                                                     n_valid, st);
  }
  if (d == 64) {
    const int err = launch_delta<64>(oo, gg, dd, bh, n, st);
    return err ? err
               : wg::launch_wgmma<64, 2, 3, true>(qq, kk, vv, gg, ll, dd, oq, ok, ov, bh, n,
                                                   n_valid, st);
  }
  const int err = launch_delta<32>(oo, gg, dd, bh, n, st);
  return err ? err : launch_mma<32>(qq, kk, vv, gg, ll, dd, oq, ok, ov, bh, n, n_valid, st);
}
