// K7: attention forward with the exact row-max (online) softmax.
//
// Replaces `_fwd_kernel` of `s3od_tpu/ops/flash_attention.py` (the
// streaming online-softmax forward, dispatched by `_flash_forward` and the
// public `flash_attention` without the static bound), and the row-max mode
// of `_fwd_kernel_single` (`static_bound=False`): both compute the same
// exact softmax, and which one the TPU runs is a VMEM rule (`_pick_blocks`)
// that is not ported. The MMDiT reaches it at every attention: 4608 tokens
// at 1024^2 (24 heads of D = 128), 4104 -> 4160 on the concept stream.
//
// Design (FA2 style, the K3 kernel's tiling): a block of 4 warps owns 64
// query rows (16 a warp) and streams 64-key tiles of K and V through a
// two-stage cp.async buffer in dynamic shared memory (87,040 bytes at
// D = 128, above the 48 KB static limit). S = Q K^T and O += P V run on
// mma.sync m16n8k16 bf16 with fp32 accumulators; the S fragment is re-packed
// as the A operand of P V, so P never leaves registers. Each thread keeps
// the running max m and its share of the denominator l for its two rows
// (g and g + 8 of its warp's 16) and rescales its O fragment by
// alpha = exp(m_prev - m_new) per tile. Tiles wholly at or past n_valid
// are skipped: there p = exp(-1e30 - m) = 0 and alpha = 1 exactly, so the
// result is the one the full loop would give.
//
// Semantics, kept to the letter:
//   - the softmax scale is already folded into q (in bf16) by the caller,
//     so s = q @ k^T;
//   - keys at or past n_valid get the bias -1e30;
//   - m starts at -1e30; m_new = max(m_prev, max_j s_j);
//   - p = exp(s - m_new) is rounded to bf16 for P V, while l sums the fp32 p;
//   - acc and l are rescaled by alpha = exp(m_prev - m_new);
//   - o = acc / l, lse = m + log l (fp32, for a later backward).
//
// Bound on the H100: 4 * BH * N^2 * D operations (two products), at
// (24, 4608, 128) 2.61e11, 0.264 ms at 989 TFLOP/s, against ~0.11 GB of
// q, k, v, o (0.03 ms at 3.35 TB/s): compute-bound on the tensor cores,
// with one exp per logit on the SFU as the second limit. This first
// version uses mma.sync and expf; wgmma with TMA loads and exp2 with a
// folded log2(e) are the next steps.
#include "mma.cuh"

using namespace s3od;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BM = 64, BN = 64, THREADS = 128;
constexpr float NEG_INF = -1e30f;

template <int D>
constexpr int smem_bytes() {
  return (BM + 4 * BN) * (D + 8) * static_cast<int>(sizeof(bf16));
}

template <int D>
__global__ void __launch_bounds__(THREADS)
    flash_online_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                            const bf16* __restrict__ v, bf16* __restrict__ o,
                            float* __restrict__ lse, int n, int n_valid) {
  constexpr int LDS = D + 8;
  constexpr int CH = D / 8;  // 16-byte chunks per row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);  // [BM][LDS]
  bf16* sK = sQ + BM * LDS;                      // [2][BN][LDS]
  bf16* sV = sK + 2 * BN * LDS;                  // [2][BN][LDS]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * BM;
  const size_t base = (size_t)blockIdx.y * n * D;
  const bf16* qb = q + base + (size_t)q0 * D;
  const bf16* kb = k + base;
  const bf16* vb = v + base;

  for (int i = tid; i < BM * CH; i += THREADS) {
    const int r = i / CH, cc = (i % CH) * 8;
    cp_async16(sQ + r * LDS + cc, qb + (size_t)r * D + cc);
  }
  auto load_kv = [&](int stage, int key0) {
    bf16* dk = sK + stage * BN * LDS;
    bf16* dv = sV + stage * BN * LDS;
    for (int i = tid; i < BN * CH; i += THREADS) {
      const int r = i / CH, cc = (i % CH) * 8;
      cp_async16(dk + r * LDS + cc, kb + (size_t)(key0 + r) * D + cc);
      cp_async16(dv + r * LDS + cc, vb + (size_t)(key0 + r) * D + cc);
    }
    cp_async_commit();
  };

  const int nkt = (n_valid + BN - 1) / BN;
  load_kv(0, 0);  // the Q copies ride in the same group

  uint32_t qf[D / 16][4];
  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  // Running max and this thread's share of the denominator, rows g, g + 8.
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;

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
      for (int ks = 0; ks < D / 16; ++ks)
        load_a_frag(qf[ks], sQ + (warp * 16) * LDS + ks * 16, LDS, lane);
    }
    const bf16* tK = sK + (kt & 1) * BN * LDS;
    const bf16* tV = sV + (kt & 1) * BN * LDS;

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
        load_b_frag_nk(b, tK + (np * 16) * LDS + ks * 16, LDS, lane);
        mma_bf16(sc[2 * np], qf[ks], b[0], b[1]);
        mma_bf16(sc[2 * np + 1], qf[ks], b[2], b[3]);
      }
    }

    // Key mask, then the tile's row maxima: a row's 64 keys are spread
    // over the 4 threads of a quad.
    float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = kt * BN + nt * 8 + 2 * t + (e & 1);
        float x = sc[nt][e];
        if (col >= n_valid) x += NEG_INF;
        sc[nt][e] = x;
        if (e < 2)
          mx0 = fmaxf(mx0, x);
        else
          mx1 = fmaxf(mx1, x);
      }
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffff, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffff, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffff, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffff, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float a0 = expf(m0 - mn0), a1 = expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;

    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(sc[nt][e] - (e < 2 ? mn0 : mn1));
        sc[nt][e] = p;
        if (e < 2)
          s0 += p;
        else
          s1 += p;
      }
    }
    l0 = l0 * a0 + s0;
    l1 = l1 * a1 + s1;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      acc[i][0] *= a0;
      acc[i][1] *= a0;
      acc[i][2] *= a1;
      acc[i][3] *= a1;
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
        load_b_frag_kn(b, tV + (kk * 16) * LDS + dp * 16, LDS, lane);
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
    lb[r0] = m0 + logf(l0);
    lb[r1] = m1 + logf(l1);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int bh, int n, int n_valid, cudaStream_t st) {
  constexpr int smem = smem_bytes<D>();
  // Above 48 KB only after this opt-in; cheap, and harmless to repeat.
  cudaError_t err = cudaFuncSetAttribute(
      flash_online_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(n / BM, bh);
  flash_online_fwd_kernel<D><<<grid, THREADS, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), static_cast<float*>(lse), n,
      n_valid);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, o: (bh, n, d) bf16; lse: (bh, n) fp32. n a multiple of 64,
// d in {64, 128}, 0 < n_valid <= n (checked by the Python wrapper).
extern "C" int s3od_flash_attention_online_fwd(const void* q, const void* k, const void* v,
                                               void* o, void* lse, int bh, int n, int d,
                                               int n_valid, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d == 128) return launch<128>(q, k, v, o, lse, bh, n, n_valid, st);
  if (d == 64) return launch<64>(q, k, v, o, lse, bh, n, n_valid, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
