// K8: attention backward under the static softmax bound.
//
// Replaces the TPU backward kernels of `s3od_tpu/ops/flash_attention.py`,
// both reached from `_bwd_rule` -> `_flash_backward`:
//   K8a `_bwd_fused_kernel` (via `_flash_backward_fused`: dq, dk and dv in
//       one pass, with a full-sequence fp32 dk/dv scratch in VMEM, used
//       while 2 * n_pad * D * 4 <= 6 MB: the 1024^2 path), and
//   K8b `_bwd_dq_kernel` + `_bwd_dkv_kernel` (the split route for longer
//       sequences: the 2048^2 path).
// Both compute the same function; which one the TPU runs is a VMEM rule
// and is not ported. One design serves every length here, two kernels on
// one stream:
//   - dkv: a block of 4 warps owns 64 keys (16 per warp, K and V held as
//     mma A fragments in registers) and loops over every 64-row query
//     tile, double-buffering Q, dO, lse and delta through cp.async;
//   - dq: a block owns 64 query rows (Q and dO as A fragments) and loops
//     over every 64-key tile of K and V.
// Nothing is shared between blocks, so no atomics and no fp32 scratch in
// device memory: every output is one block's deterministic sum.
//
// Semantics, kept to the letter (`_bwd_*_kernel`, scale = 1 because K2
// folds D^-0.5 into q):
//   s = q k^T; keys at or past n_valid get -1e30 added;
//   p = exp(min(s - lse, 0)) — the clamp keeps p <= 1 where the static
//       bound left lse below an out-of-window row max;
//   dp = dO v^T; ds = p * (dp - delta), delta = rowsum(o * dO) in fp32
//       (computed by the wrapper, as JAX computes it outside Pallas);
//   dv = bf16(p)^T dO, dk = bf16(ds)^T q, dq = bf16(ds) k, each summed in
//       fp32 and rounded to bf16 once.
//
// Bound on the H100: at ViT-B, 1024^2, batch 4 (BH = 48, N = 4160, D = 64)
// the fused algorithm's 5 products are 5 x 2 x 48 x 4160^2 x 64 = 532 GFLOP
// (0.54 ms at 989 TFLOP/s) over ~100 MB of inputs and outputs (0.03 ms), so
// it is compute-bound. This split design runs 7 products (s and dp twice)
// with mma.sync from shared memory; a fused one-pass kernel and wgmma are
// the later steps.
#include "mma.cuh"

using namespace s3od;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BM = 64, BN = 64, THREADS = 128;
constexpr float NEG_INF = -1e30f;

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
int launch(const bf16* q, const bf16* k, const bf16* v, const bf16* g, const float* lse,
           const float* delta, bf16* dq, bf16* dk, bf16* dv, int bh, int n, int n_valid,
           cudaStream_t st) {
  dim3 grid(n / BM, bh);
  flash_bwd_dkv_kernel<D><<<grid, THREADS, 0, st>>>(q, k, v, g, lse, delta, dk, dv, n, n_valid);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dq_kernel<D><<<grid, THREADS, 0, st>>>(q, k, v, g, lse, delta, dq, n, n_valid);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, g (the output's cotangent), dq, dk, dv: (bh, n, d) bf16; lse and
// delta: (bh, n) fp32. n a multiple of 64, d in {32, 64} (checked by the
// Python wrapper).
extern "C" int s3od_flash_attention_bwd(const void* q, const void* k, const void* v,
                                        const void* g, const void* lse, const void* delta,
                                        void* dq, void* dk, void* dv, int bh, int n, int d,
                                        int n_valid, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* qq = static_cast<const bf16*>(q);
  const bf16* kk = static_cast<const bf16*>(k);
  const bf16* vv = static_cast<const bf16*>(v);
  const bf16* gg = static_cast<const bf16*>(g);
  const float* ll = static_cast<const float*>(lse);
  const float* dd = static_cast<const float*>(delta);
  bf16* oq = static_cast<bf16*>(dq);
  bf16* ok = static_cast<bf16*>(dk);
  bf16* ov = static_cast<bf16*>(dv);
  if (d == 64) return launch<64>(qq, kk, vv, gg, ll, dd, oq, ok, ov, bh, n, n_valid, st);
  if (d == 32) return launch<32>(qq, kk, vv, gg, ll, dd, oq, ok, ov, bh, n, n_valid, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
