// K3 and K6: attention forward under the static softmax bound.
//
// Replaces two TPU kernels of `s3od_tpu/ops/flash_attention.py`, both via
// `_flash_forward(static_bound=True)` <- `_flash_attention_bhnd`:
//   K3 `_fwd_kernel_single` (1024^2: all 4104 keys of a row in one VMEM
//      block), and
//   K6 `_fwd_kernel_stream_static` (2048^2: 16389 tokens streamed over 33
//      K blocks of 512, q blocks raised to 2112 rows).
// Which of the two the TPU runs is a VMEM rule (`_pick_blocks`) and is not
// ported: under the static bound they compute the same thing, and one
// kernel streams key tiles at every length here.
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
// maxima sit inside the window). The exponential is taken in base 2 with
// log2(e) folded in, p = exp2(fma(s, log2 e, -40 log2 e)): a few fp32 ulps
// from exp(s - 40), far below the one bf16 rounding of p.
//
// Bound on the H100: 4 BH N^2 D operations (two products). At ViT-B,
// 1024^2 (BH = 12, N = 4160, D = 64) 53.2 GFLOP, 0.0538 ms at 989
// TFLOP/s, over ~20 MB (0.006 ms at 3.35 TB/s); at 2048^2 (N = 16448) 831
// GFLOP, 0.840 ms, over ~76 MB: compute-bound on the tensor cores. At
// D = 64 the exponentials are a second limit of the same size: BH N^2 of
// them at ~3.9e12/s on the SFU take as long as the products.
//
// Design, chosen by an explicit dispatch on D in the entry point below:
//   D = 64 (ViT-B, ViT-L: every serving and training path): the
//     warp-specialised kernel of `flash_fwd_ws.cuh` with STATIC = true
//     and 3 consumer warpgroups, K7's structure. A block of 512 threads
//     owns 192 query rows of one head. Warpgroup 0 (32 registers) loads Q
//     once, then 128-key tiles of K and V into two-stage rings by TMA
//     through 3-D (D, N, BH) maps with the 128-byte swizzle; warpgroups
//     1-3 (160 registers; ptxas fits the kernel in 128 without spills)
//     each own 64 rows: S = Q K^T by SS wgmma m64n128k16 (64 fp32
//     accumulator registers a thread), O += P V by RS wgmma m64n64k16 from
//     S's accumulator packed to bf16 in place (32 registers; O 32), taking
//     turns on named barriers so one's exponentials run under the others'
//     products. Shared memory: Q 24 KB + 2 x 2 stages x 16 KB of K and V
//     = 89 KB with alignment and 9 mbarriers. On the H100, three consumer
//     warpgroups ran faster than two, and one MUFU.EX2 per logit
//     (`exp2_ftz`) faster than exp2f's range-checked form (side
//     experiments; PERF.md section 6).
//     Three kinds of key: below n_valid, their logit; from n_valid to N,
//     -1e30 then the clip, e^-80 (59 keys at 1024^2); at or past N —
//     N = 4160 and 16448 are odd multiples of 64, so the last 128-key tile
//     reaches 64 keys past N, which TMA fills with zeros — p = 0, which a
//     zero key would otherwise not get (s = 0 gives e^-40). Every tile up
//     to N is walked: none can be skipped, since masked keys still weigh
//     e^-80 and, on a row whose logits all sit below -40, weigh as much
//     as the valid ones. The masks are tested only from the tile that
//     holds n_valid. Query rows past N are computed on zeros and not
//     stored. 33 key tiles at 1024^2, 129 at 2048^2; grids of 22 x BH and
//     86 x BH blocks.
//   D = 32 (the committed tiny checkpoints): the first, mma.sync kernel
//     below, a block of 4 warps owning 64 query rows, 64-key tiles through
//     a two-stage cp.async pipeline, mma.sync from padded shared memory,
//     exp in base e. Each thread's share of a row denominator l is a sequential fp32
//     sum of at most N / 4 terms in [0, 1], so its relative rounding error
//     stays below ~2.5e-4, and lse = 40 + log l below ~2.5e-4 absolute.
// All offsets are formed in size_t.
#include "flash_fwd_ws.cuh"
#include "mma.cuh"

using namespace s3od;
typedef __nv_bfloat16 bf16;

namespace {

// The D = 32 route: the mma.sync kernel.
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

// q, k, v, o: (bh, n, d) bf16, 16-byte aligned; lse: (bh, n) fp32. n a
// multiple of 64, d in {32, 64}, 0 < n_valid <= n (checked by the Python
// wrapper). D = 64 takes the wgmma kernel, D = 32 the mma.sync kernel.
extern "C" int s3od_flash_attention_fwd(const void* q, const void* k, const void* v,
                                        void* o, void* lse, int bh, int n, int d,
                                        int n_valid, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0 || n % 64 || n_valid <= 0 || n_valid > n)
    return static_cast<int>(cudaErrorInvalidValue);
  if (d == 64) return s3od::flash_ws::launch_fwd<64, true, 3>(q, k, v, o, lse, bh, n, n_valid, st);
  if (d != 32) return static_cast<int>(cudaErrorInvalidValue);
  flash_fwd_kernel<32><<<dim3(n / BM, bh), THREADS, 0, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), static_cast<float*>(lse), n, n_valid);
  return static_cast<int>(cudaGetLastError());
}
