// E1, E3a and E4: the flash-softmax experiments' attention forward, one
// template for all of their variants.
//
// Replaces three TPU kernels of the experiments in `benchmarks/`:
//   E1 `exp_flash_softmax.py` `make_kernel` (online softmax on a
//      (bh, nq, nk) grid; variants base / exp2 / exp2_bf16, no lse);
//   E3a `exp_exp2.py` `_exp2_flash` (`_exp2_single_kernel` and
//      `_exp2_stream_kernel`: the static +-40 bound in base 2, with lse);
//   E4 `exp_flash_single.py` `make_run` (one K block with lse; variants
//      base / nomax_inscale / nomax_clip2 / min_eps / nomax).
// What varies between them is the softmax, not the products, so one kernel
// covers them, switched by the template arguments:
//   ONLINE    row max: running m per row, tiles rescaled by
//             alpha = exp(m_prev - m_new) (E1, E4 base); else the static
//             bound: p = exp(clip(s, lo, hi) - hi), m = hi fixed, no
//             rescale (lo = -inf gives the one-sided min(s, hi) - hi);
//   BASE2     exp2 instead of exp (the caller folds log2 e into `mult`);
//   BF16_ARG  p = exp2(bf16(s - m)) on the packed `ex2.approx.ftz.bf16x2`
//             unit, Hopper's counterpart of the TPU's packed bf16 VPU ops:
//             p itself is bf16 and l sums those bf16 values. It may differ
//             from exp2-then-round by one bf16 step.
// and by runtime arguments: the logits are s = (q k^T) * mult + bias (bias
// fp32 per key, or none), l gets l_eps added before o = acc / l, lse is
// written where its pointer is not null (lse = m + log l, m * ln 2 in base
// 2), and `extra_keys` zero keys with bias -1e30 are appended after the n
// real ones. That last one is E3a's padding, which is part of its function:
// the TPU kernel pads the keys to its block multiple and masks them, and a
// masked key still weighs exp(lo - hi) after the clip (e^-80). Here such
// keys are never loaded: their weight goes into l once per row.
//
// The sequence length need not be a multiple of the tile (4104 = 64 * 64 +
// 8 at the experiments' default): query rows past n are computed on zeros
// and not stored, keys past n are loaded as zeros (cp.async with source
// size 0) and given p = 0 exactly, in the last tile only (the others skip
// every check). They are NOT given the -1e30 bias, which under a static
// bound would still weigh e^-60 or e^-80.
//
// The row max of E1 (block_k = n) and E4 base is taken over all keys before
// the exp on the TPU. Here it is one pass with the online rescale (as K7):
// it differs from the two-pass form only in where p is rounded to bf16 for
// P V (and, for exp2_bf16, where s - m is rounded), inside one bf16 step.
//
// Tiling (the K3/K7 kernels' design at D = 64): a block of 4 warps owns 64
// query rows, 16 a warp, and streams 64-key tiles of K and V through a
// two-stage cp.async buffer (46 KB of static shared memory); S = Q K^T and
// O += P V run on mma.sync m16n8k16 bf16 with fp32 accumulators, and the S
// fragment is re-packed as the A operand of P V. exp and exp2 are the
// accurate `expf` / `exp2f` (no fast math), as in K3 and K7.
//
// Bound on the H100 at the experiments' default (96, 4104, 64): 4 BH N^2 D
// = 4.14e11 tensor-core FLOP, 0.419 ms at 989 TFLOP/s, and BH N^2 = 1.6e9
// exponentials, 0.415 ms at the SFUs' ~3.9e12/s: co-bound by the products
// and the exponentials; the 0.2 GB of q, k, v, o take 0.06 ms.
#include <math.h>

#include "mma.cuh"

using namespace s3od;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BM = 64, BN = 64, D = 64, THREADS = 128;
constexpr int LDS = D + 8;  // padded shared-memory row (bank spread)
constexpr int CH = D / 8;   // 16-byte chunks per row
constexpr float NEG_INF = -1e30f;
constexpr float LN2 = 0.6931471805599453f;

// 16-byte global -> shared copy; when `valid` is false nothing is read and
// the 16 bytes are zero-filled.
__device__ __forceinline__ void cp_async16_zfill(void* smem, const void* gmem, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(smem)),
               "l"(gmem), "r"(valid ? 16 : 0));
}

template <bool BASE2>
__device__ __forceinline__ float ex(float x) {
  return BASE2 ? exp2f(x) : expf(x);
}

// 2^x of two values rounded to bf16, on the packed bf16x2 unit: the packed
// bf16 result (lo value in the low half).
__device__ __forceinline__ uint32_t ex2_bf16x2(float lo, float hi) {
  const uint32_t a = pack_bf16(lo, hi);
  uint32_t d;
  asm("ex2.approx.ftz.bf16x2 %0, %1;\n" : "=r"(d) : "r"(a));
  return d;
}
__device__ __forceinline__ float bf16_lo(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }

template <bool ONLINE, bool BASE2, bool BF16_ARG>
__global__ void __launch_bounds__(THREADS)
    exp_flash_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const float* __restrict__ bias,
                     bf16* __restrict__ o, float* __restrict__ lse, int n, float mult,
                     float lo, float hi, float l_eps, int extra_keys) {
  __shared__ __align__(16) bf16 sQ[BM][LDS];
  __shared__ __align__(16) bf16 sK[2][BN][LDS];
  __shared__ __align__(16) bf16 sV[2][BN][LDS];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * BM;
  const size_t base = (size_t)blockIdx.y * n * D;
  const bf16* qb = q + base;
  const bf16* kb = k + base;
  const bf16* vb = v + base;

  for (int i = tid; i < BM * CH; i += THREADS) {
    const int r = i / CH, cc = (i % CH) * 8;
    const bool ok = q0 + r < n;
    cp_async16_zfill(&sQ[r][cc], qb + (size_t)(ok ? q0 + r : 0) * D + cc, ok);
  }
  auto load_kv = [&](int stage, int key0) {
    for (int i = tid; i < BN * CH; i += THREADS) {
      const int r = i / CH, cc = (i % CH) * 8;
      const bool ok = key0 + r < n;
      const size_t row = ok ? key0 + r : 0;
      cp_async16_zfill(&sK[stage][r][cc], kb + row * D + cc, ok);
      cp_async16_zfill(&sV[stage][r][cc], vb + row * D + cc, ok);
    }
    cp_async_commit();
  };

  const int nkt = (n + BN - 1) / BN;
  load_kv(0, 0);  // the Q copies ride in the same group

  uint32_t qf[D / 16][4];
  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  // Row max (or the static shift) and this thread's share of the
  // denominator, for rows g and g + 8 of the warp's 16.
  float m0 = ONLINE ? NEG_INF : hi, m1 = m0, l0 = 0.f, l1 = 0.f;
  // The exponent's argument: s - m, or clip(s, lo, hi) - hi.
  auto arg = [&](float x, float m) {
    return ONLINE ? x - m : fminf(fmaxf(x, lo), hi) - hi;
  };

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
    const int st = kt & 1;

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
        load_b_frag_nk(b, &sK[st][np * 16][ks * 16], LDS, lane);
        mma_bf16(sc[2 * np], qf[ks], b[0], b[1]);
        mma_bf16(sc[2 * np + 1], qf[ks], b[2], b[3]);
      }
    }

    // Logits s * mult + bias. Only the last tile can hold keys past n: there
    // they become -inf (so p = 0 under the row max, and are zeroed below
    // under the static bound); the other tiles skip every check.
    const bool tail = (kt + 1) * BN > n;
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = kt * BN + nt * 8 + 2 * t + (e & 1);
        sc[nt][e] *= mult;
        if (bias != nullptr) sc[nt][e] += __ldg(bias + min(col, n - 1));
      }
    }
    if (tail) {
#pragma unroll
      for (int nt = 0; nt < BN / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (kt * BN + nt * 8 + 2 * t + (e & 1) >= n) sc[nt][e] = -INFINITY;
    }
    float mx0 = -INFINITY, mx1 = -INFINITY;
    if (ONLINE) {
#pragma unroll
      for (int nt = 0; nt < BN / 8; ++nt) {
        mx0 = fmaxf(mx0, fmaxf(sc[nt][0], sc[nt][1]));
        mx1 = fmaxf(mx1, fmaxf(sc[nt][2], sc[nt][3]));
      }
    }
    float a0 = 1.f, a1 = 1.f;
    if (ONLINE) {  // a row's 64 keys are spread over the 4 threads of a quad
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffff, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffff, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffff, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffff, mx1, 2));
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      a0 = ex<BASE2>(m0 - mn0);
      a1 = ex<BASE2>(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
    }

    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
      if (BF16_ARG) {
        const uint32_t p01 = ex2_bf16x2(arg(sc[nt][0], m0), arg(sc[nt][1], m0));
        const uint32_t p23 = ex2_bf16x2(arg(sc[nt][2], m1), arg(sc[nt][3], m1));
        sc[nt][0] = bf16_lo(p01);
        sc[nt][1] = bf16_hi(p01);
        sc[nt][2] = bf16_lo(p23);
        sc[nt][3] = bf16_hi(p23);
      } else {
        sc[nt][0] = ex<BASE2>(arg(sc[nt][0], m0));
        sc[nt][1] = ex<BASE2>(arg(sc[nt][1], m0));
        sc[nt][2] = ex<BASE2>(arg(sc[nt][2], m1));
        sc[nt][3] = ex<BASE2>(arg(sc[nt][3], m1));
      }
    }
    if (!ONLINE && tail) {  // the clip lifted keys past n to lo
#pragma unroll
      for (int nt = 0; nt < BN / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (kt * BN + nt * 8 + 2 * t + (e & 1) >= n) sc[nt][e] = 0.f;
    }
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
      s0 += sc[nt][0] + sc[nt][1];
      s1 += sc[nt][2] + sc[nt][3];
    }
    if (ONLINE) {
      l0 = l0 * a0 + s0;
      l1 = l1 * a1 + s1;
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        acc[i][0] *= a0;
        acc[i][1] *= a0;
        acc[i][2] *= a1;
        acc[i][3] *= a1;
      }
    } else {
      l0 += s0;
      l1 += s1;
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
        load_b_frag_kn(b, &sV[st][kk * 16][dp * 16], LDS, lane);
        mma_bf16(acc[2 * dp], a, b[0], b[1]);
        mma_bf16(acc[2 * dp + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();
  }

  l0 += __shfl_xor_sync(0xffffffff, l0, 1);
  l0 += __shfl_xor_sync(0xffffffff, l0, 2);
  l1 += __shfl_xor_sync(0xffffffff, l1, 1);
  l1 += __shfl_xor_sync(0xffffffff, l1, 2);
  if (extra_keys > 0) {  // zero keys with bias -1e30: s = -1e30
    const float pa = arg(NEG_INF, m0), pb = arg(NEG_INF, m1);
    const float pe0 = BF16_ARG ? bf16_lo(ex2_bf16x2(pa, pa)) : ex<BASE2>(pa);
    const float pe1 = BF16_ARG ? bf16_lo(ex2_bf16x2(pb, pb)) : ex<BASE2>(pb);
    l0 += extra_keys * pe0;
    l1 += extra_keys * pe1;
  }
  l0 += l_eps;
  l1 += l_eps;
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  bf16* ob = o + base;
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
    const int col = nt * 8 + 2 * t;
    if (r0 < n)
      *reinterpret_cast<uint32_t*>(ob + (size_t)r0 * D + col) =
          pack_bf16(acc[nt][0] / l0, acc[nt][1] / l0);
    if (r1 < n)
      *reinterpret_cast<uint32_t*>(ob + (size_t)r1 * D + col) =
          pack_bf16(acc[nt][2] / l1, acc[nt][3] / l1);
  }
  if (lse != nullptr && t == 0) {
    float* lb = lse + (size_t)blockIdx.y * n;
    const float c = BASE2 ? LN2 : 1.f;
    if (r0 < n) lb[r0] = m0 * c + logf(l0);
    if (r1 < n) lb[r1] = m1 * c + logf(l1);
  }
}

template <bool ONLINE, bool BASE2, bool BF16_ARG>
int launch(const void* q, const void* k, const void* v, const void* bias, void* o, void* lse,
           int bh, int n, float mult, float lo, float hi, float l_eps, int extra_keys,
           cudaStream_t st) {
  dim3 grid((n + BM - 1) / BM, bh);
  exp_flash_kernel<ONLINE, BASE2, BF16_ARG><<<grid, THREADS, 0, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const float*>(bias), static_cast<bf16*>(o), static_cast<float*>(lse), n, mult,
      lo, hi, l_eps, extra_keys);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, o: (bh, n, 64) bf16; bias: (n,) fp32 or null; lse: (bh, n) fp32
// or null. variant = static (1) | base2 (2) | bf16_arg (4); the five used
// combinations are instantiated (checked by the Python wrapper).
extern "C" int s3od_exp_flash_fwd(const void* q, const void* k, const void* v,
                                  const void* bias, void* o, void* lse, int bh, int n,
                                  int variant, float mult, float lo, float hi, float l_eps,
                                  int extra_keys, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case 0:
      return launch<true, false, false>(q, k, v, bias, o, lse, bh, n, mult, lo, hi, l_eps,
                                        extra_keys, st);
    case 2:
      return launch<true, true, false>(q, k, v, bias, o, lse, bh, n, mult, lo, hi, l_eps,
                                       extra_keys, st);
    case 6:
      return launch<true, true, true>(q, k, v, bias, o, lse, bh, n, mult, lo, hi, l_eps,
                                      extra_keys, st);
    case 1:
      return launch<false, false, false>(q, k, v, bias, o, lse, bh, n, mult, lo, hi, l_eps,
                                         extra_keys, st);
    case 3:
      return launch<false, true, false>(q, k, v, bias, o, lse, bh, n, mult, lo, hi, l_eps,
                                        extra_keys, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
