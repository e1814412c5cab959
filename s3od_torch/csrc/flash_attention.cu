// K3 and K6: attention forward under the static softmax bound.
//
// Replaces two TPU kernels of `s3od_tpu/ops/flash_attention.py`, both via
// `_flash_forward(static_bound=True)` <- `_flash_attention_bhnd`:
//   K3 `_fwd_kernel_single` (1024^2: all 4104 keys of a row in one VMEM
//      block), and
//   K6 `_fwd_kernel_stream_static` (2048^2: 16389 tokens streamed over 33
//      K blocks of 512, q blocks raised to 2112 rows).
// Which of the two the TPU runs is a VMEM rule (`_pick_blocks`) and is not
// ported. Here a block of 4 warps owns 64 query rows and streams over
// 64-key tiles of K and V through a two-stage cp.async pipeline at every
// length: 65 tiles at 1024^2 (N = 4160), 257 at 2048^2 (N = 16448). Each
// thread's share of a row denominator l is a sequential fp32 sum of at most
// N / 4 terms in [0, 1] (4112 at 2048^2), so its relative rounding error
// stays below ~2.5e-4 even in the worst case, and lse = 40 + log l
// below ~2.5e-4 in absolute terms. All offsets are formed in size_t.
//
// Semantics, kept to the letter:
//   - the softmax scale is already folded into q (K2), so s = q @ k^T;
//   - keys at or past n_valid get -1e30, then s is clipped to [-40, 40]
//     BEFORE exp(s - 40): masked keys weigh e^-80 as on the TPU, and a row
//     whose logits all sit below -40 still has l >= N e^-80 > 0 (finite);
//   - p is rounded to bf16 for P @ V while l sums the fp32 p;
//   - o = acc / l, lse = 40 + log l.
// Because the shift is a constant, tiles simply add: no running max and no
// rescale of the accumulator (exact, by shift invariance, while the row
// maxima sit inside the window).
//
// Bound on the H100: at ViT-B, 1024^2 (BH = 12, N = 4160, D = 64) it is
// 2 x 2 x 12 x 4160^2 x 64 = 53 GFLOP over ~20 MB, at 2048^2 (N = 16448)
// 831 GFLOP over ~76 MB: compute-bound on the tensor cores, with the exp
// of every logit on the SFU as the second limit.
// This first version keeps S and P in registers (FA2 style: the S
// accumulator fragment is re-packed as the A operand of P @ V) and uses
// mma.sync; wgmma and exp2 with a folded log2(e) are the next steps.
#include "mma.cuh"

using namespace s3od;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BM = 64, BN = 64, THREADS = 128;
constexpr float BOUND_HI = 40.f, BOUND_LO = -40.f, NEG_INF = -1e30f;

template <int D>
__global__ void __launch_bounds__(THREADS)
    flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o,
                     float* __restrict__ lse, int n, int n_valid) {
  constexpr int LDS = D + 8;
  constexpr int CH = D / 8;  // 16-byte chunks per row
  __shared__ __align__(16) bf16 sQ[BM][LDS];
  __shared__ __align__(16) bf16 sK[2][BN][LDS];
  __shared__ __align__(16) bf16 sV[2][BN][LDS];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * BM;
  const size_t base = (size_t)blockIdx.y * n * D;
  const bf16* qb = q + base + (size_t)q0 * D;
  const bf16* kb = k + base;
  const bf16* vb = v + base;

  for (int i = tid; i < BM * CH; i += THREADS) {
    const int r = i / CH, cc = (i % CH) * 8;
    cp_async16(&sQ[r][cc], qb + (size_t)r * D + cc);
  }
  auto load_kv = [&](int stage, int key0) {
    for (int i = tid; i < BN * CH; i += THREADS) {
      const int r = i / CH, cc = (i % CH) * 8;
      cp_async16(&sK[stage][r][cc], kb + (size_t)(key0 + r) * D + cc);
      cp_async16(&sV[stage][r][cc], vb + (size_t)(key0 + r) * D + cc);
    }
    cp_async_commit();
  };

  const int nkt = n / BN;
  load_kv(0, 0);  // the Q copies ride in the same group

  uint32_t qf[D / 16][4];
  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  float l0 = 0.f, l1 = 0.f;  // fp32 denominators of rows g and g + 8

  for (int kt = 0; kt < nkt; ++kt) {
    if (kt + 1 < nkt) {
      load_kv((kt + 1) & 1, (kt + 1) * BN);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (kt == 0) {
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) load_a_frag(qf[ks], &sQ[warp * 16][ks * 16], LDS, lane);
    }
    const int s = kt & 1;

    float sc[BN / 8][4];
#pragma unroll
    for (int i = 0; i < BN / 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
#pragma unroll
      for (int np = 0; np < BN / 16; ++np) {
        uint32_t b[4];
        load_b_frag_nk(b, &sK[s][np * 16][ks * 16], LDS, lane);
        mma_bf16(sc[2 * np], qf[ks], b[0], b[1]);
        mma_bf16(sc[2 * np + 1], qf[ks], b[2], b[3]);
      }
    }

    // mask -> clip -> exp(s - 40); row sums in fp32.
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = kt * BN + nt * 8 + 2 * t + (e & 1);
        float x = sc[nt][e];
        if (col >= n_valid) x += NEG_INF;
        x = fminf(fmaxf(x, BOUND_LO), BOUND_HI);
        const float p = expf(x - BOUND_HI);
        sc[nt][e] = p;
        if (e < 2)
          l0 += p;
        else
          l1 += p;
      }
    }

    // acc += bf16(P) @ V
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(sc[2 * kk][0], sc[2 * kk][1]);
      a[1] = pack_bf16(sc[2 * kk][2], sc[2 * kk][3]);
      a[2] = pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]);
      a[3] = pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3]);
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t b[4];
        load_b_frag_kn(b, &sV[s][kk * 16][dp * 16], LDS, lane);
        mma_bf16(acc[2 * dp], a, b[0], b[1]);
        mma_bf16(acc[2 * dp + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();
  }

  // A row's 64 keys per tile are spread over the 4 threads of a quad.
  l0 += __shfl_xor_sync(0xffffffff, l0, 1);
  l0 += __shfl_xor_sync(0xffffffff, l0, 2);
  l1 += __shfl_xor_sync(0xffffffff, l1, 1);
  l1 += __shfl_xor_sync(0xffffffff, l1, 2);
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  bf16* ob = o + base;
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
    const int col = nt * 8 + 2 * t;
    *reinterpret_cast<uint32_t*>(ob + (size_t)r0 * D + col) =
        pack_bf16(acc[nt][0] * inv0, acc[nt][1] * inv0);
    *reinterpret_cast<uint32_t*>(ob + (size_t)r1 * D + col) =
        pack_bf16(acc[nt][2] * inv1, acc[nt][3] * inv1);
  }
  if (t == 0) {
    float* lb = lse + (size_t)blockIdx.y * n;
    lb[r0] = BOUND_HI + logf(l0);
    lb[r1] = BOUND_HI + logf(l1);
  }
}

}  // namespace

// q, k, v, o: (bh, n, d) bf16; lse: (bh, n) fp32. n a multiple of 64,
// d in {32, 64} (checked by the Python wrapper).
extern "C" int s3od_flash_attention_fwd(const void* q, const void* k, const void* v,
                                        void* o, void* lse, int bh, int n, int d,
                                        int n_valid, void* stream) {
  dim3 grid(n / BM, bh);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* qq = static_cast<const bf16*>(q);
  const bf16* kk = static_cast<const bf16*>(k);
  const bf16* vv = static_cast<const bf16*>(v);
  bf16* oo = static_cast<bf16*>(o);
  float* ll = static_cast<float*>(lse);
  if (d == 64) {
    flash_fwd_kernel<64><<<grid, THREADS, 0, st>>>(qq, kk, vv, oo, ll, n, n_valid);
  } else if (d == 32) {
    flash_fwd_kernel<32><<<grid, THREADS, 0, st>>>(qq, kk, vv, oo, ll, n, n_valid);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
