// K5: the ViT MLP — up-proj + bias, erf-GELU, down-proj + bias,
// x layerscale, + residual — as two warp-specialised, persistent wgmma
// GEMMs with fused epilogues, launched back to back by one entry point.
//
// Replaces the TPU kernel `s3od_tpu/ops/mlp_fused.py:_kernel` (via
// `mlp_fused` <- `vit_block`). Inputs: x = LayerNorm_norm2(stream) and the
// residual r, both (rows, C) bf16; Wu (F, C) and Wd (C, F) in nn.Linear
// layout (row-major (n, k): both are K-major B operands as stored, no
// transpose); bf16 vectors bu (F,), bd and ls (C,). Output (rows, C) bf16:
//   h   = bf16(gelu_erf(x @ Wu^T + bu))        fp32 accumulate, GELU on fp32
//   out = bf16(r + (h @ Wd^T + bd) * ls)       fp32 until the one rounding
// — the TPU kernel's rounding points exactly. GELU uses CUDA's erff
// (<= 2 ulp); the TPU kernel's rational erf differs from it by <= 1.5e-7.
//
// Bound on the H100: at ViT-B, 1024^2 b1 the two products are 2 x 2 x 4160
// x 768 x 3072 = 39 GFLOP, 0.040 ms at 989 TFLOP/s; each is far above the
// card's ~295 operations a byte. The TPU kernel keeps the hidden on chip;
// here that would pin an fp32 (rows x C) accumulator in registers across
// the whole F loop (128 x 768 fp32 is 384 KB, more than an SM's register
// file), so the hidden goes through device memory instead: 25.6 MB at b1,
// which stays in the 50 MB L2 between the two launches, and a 0.82 GB
// round trip at b16 (~0.24 ms of HBM time under ~0.63 ms of products).
//
// Each GEMM (C = A @ B^T, A (M, K), B (N, K), both K-contiguous):
//   - a persistent grid of min(tiles, SMs) blocks walks 128 x BN output
//     tiles, N fastest, so the blocks in flight share A rows in L2;
//   - warpgroup 0 is the producer: one thread keeps a ring of stages of
//     TMA loads (128 x 64 of A and BN x 64 of B, 128-byte swizzle) in
//     flight, on full/empty mbarriers; `setmaxnreg` drops it to 40
//     registers;
//   - warpgroups 1 and 2 are consumers with 232 registers: each owns 64
//     rows of the tile and runs SS wgmma m64nBNk16 over each stage into
//     its fp32 accumulator and frees the stage; after the K loop it runs
//     the epilogue from the accumulator into a 64 x BN staging tile in
//     shared memory (128-byte swizzled, so the fragment writes hit every
//     bank once) and one thread stores it with TMA, asynchronously, while
//     the warpgroup goes on to the next tile and the producer already
//     loads it. The down GEMM's residual tile arrives in the same staging
//     tile by TMA, issued at the start of the tile. TMA zero-fills loads
//     past M and clips stores there. (Fragment stores straight to global
//     memory, 4 bytes a thread over 8 rows, were the largest cost of the
//     up-projection on the H100.)
// BN (256, 192, 128 or 64, dividing N) is chosen per shape on the host
// (`pick_bn`, mirrored by `s3od_torch/ops/mlp_fused.py:gemm_plan`); the
// ring has 4 stages, 3 at BN = 256, where the staging tiles take 64 KB.
//
// Rounding: the wgmma accumulator sums all of K, and rounds the bf16
// outputs otherwise than fp64 more often than an fp32 SIMT product does
// (`chip_smoke.py`'s K5 phase logs both shares). Adding each K block's
// fragment into an fp32 accumulator with FADD closes most of the gap but
// needs a second fragment (BN registers a thread): on the H100 it spilled
// at BN = 192 and, where it did not spill, cost time. The checks hold
// without it (max 5e-3 of max|plain|).
#include "hopper.cuh"

using namespace s3od;
using namespace s3od::hopper;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BM = 128, BK = 64, THREADS = 384;
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
constexpr int UP_GELU = 0, DOWN_RESIDUAL = 1;
constexpr int ATOM = 64 * 64;  // elements of a 64-row x 64-column staging atom

template <int BN>
__host__ __device__ constexpr int stages() {
  return BN == 256 ? 3 : 4;
}

template <int BN>
__host__ __device__ constexpr int smem_bytes() {
  // 1024 bytes of slack to align the ring; the A and B stages; two 64 x BN
  // staging tiles; full + empty barriers per stage and a residual barrier
  // per consumer warpgroup.
  return 1024 + stages<BN>() * (BM + BN) * BK * 2 + 2 * 64 * BN * 2 +
         (2 * stages<BN>() + 2) * 8;
}

__device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
}

template <int BN, int EPI>
__global__ void __launch_bounds__(THREADS, 1)
    mlp_gemm_kernel(const __grid_constant__ CUtensorMap map_a,
                    const __grid_constant__ CUtensorMap map_b,
                    const __grid_constant__ CUtensorMap map_out,
                    const __grid_constant__ CUtensorMap map_res, const bf16* __restrict__ bias,
                    const bf16* __restrict__ ls, int m, int n, int k) {
  constexpr int STAGES = stages<BN>();
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  bf16* sA = reinterpret_cast<bf16*>(base);  // [STAGES][BM][BK], swizzled
  bf16* sB = sA + STAGES * BM * BK;           // [STAGES][BN][BK], swizzled
  bf16* sC = sB + STAGES * BN * BK;           // [2][BN / 64][64][64], swizzled
  uint64_t* full = reinterpret_cast<uint64_t*>(sC + 2 * 64 * BN);
  uint64_t* empty = full + STAGES;
  uint64_t* res_full = empty + STAGES;  // [2]

  const int n_tiles = n / BN;
  const int tiles = ((m + BM - 1) / BM) * n_tiles;
  const int kblocks = k / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2 * 128);
    }
    mbar_init(&res_full[0], 1);
    mbar_init(&res_full[1], 1);
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      int stage = 0, phase = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int tm = tile / n_tiles, tn = tile - tm * n_tiles;
        for (int kb = 0; kb < kblocks; ++kb) {
          mbar_wait(&empty[stage], phase ^ 1);
          mbar_expect_tx(&full[stage], (BM + BN) * BK * 2);
          tma_load_2d(sA + stage * BM * BK, &map_a, &full[stage], kb * BK, tm * BM);
          tma_load_2d(sB + stage * BN * BK, &map_b, &full[stage], kb * BK, tn * BN);
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    setmaxnreg_inc<CONSUMER_REGS>();
    const int half = wg - 1;
    const int t = threadIdx.x - 128 * wg;
    const int row_w = (t >> 5) * 16 + ((t & 31) >> 2);  // fragment row in the 64
    const int col_in = 2 * (t & 3);
    bf16* stage_c = sC + half * 64 * BN;
    float acc[BN / 2];
    int stage = 0, phase = 0, tile_i = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++tile_i) {
      const int tm = tile / n_tiles, tn = tile - tm * n_tiles;
      const int row0 = tm * BM + half * 64;
      if (t == 0) {
        tma_store_wait_read();  // the previous tile's store has read stage_c
        if (EPI == DOWN_RESIDUAL) {
          mbar_expect_tx(&res_full[half], 64 * BN * 2);
#pragma unroll
          for (int a = 0; a < BN / 64; ++a)
            tma_load_2d(stage_c + a * ATOM, &map_res, &res_full[half], tn * BN + a * 64, row0);
        }
      }
      for (int kb = 0; kb < kblocks; ++kb) {
        mbar_wait(&full[stage], phase);
        const bf16* a = sA + stage * BM * BK + half * 64 * BK;
        const bf16* b = sB + stage * BN * BK;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          WgmmaSS<BN>::mma(acc, desc_sw128(a + kk * 16), desc_sw128(b + kk * 16),
                           (kb | kk) != 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
        mbar_arrive(&empty[stage]);
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }

      // Epilogue into the staging tile: element (row, col) of the 64 x BN
      // tile sits in atom col / 64, row `row`, 16-byte chunk
      // (col % 64 / 8) ^ (row % 8) — TMA's 128-byte swizzle.
      if (EPI == DOWN_RESIDUAL)
        mbar_wait(&res_full[half], tile_i & 1);
      else
        named_sync(1 + half, 128);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = 8 * j + col_in;
        const float2 bb =
            __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(bias + tn * BN + col));
        float2 l2 = make_float2(0.f, 0.f);
        if (EPI == DOWN_RESIDUAL)
          l2 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(ls + tn * BN + col));
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int row = row_w + 8 * hr;
          bf16* at = stage_c + (col / 64) * ATOM + row * 64 + ((((col % 64) >> 3) ^ (row & 7)) << 3) +
                     (col & 7);
          const float v0 = acc[4 * j + 2 * hr] + bb.x;
          const float v1 = acc[4 * j + 2 * hr + 1] + bb.y;
          uint32_t packed;
          if (EPI == UP_GELU) {
            packed = pack_bf16(gelu_erf(v0), gelu_erf(v1));
          } else {
            const float2 r2 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(at));
            packed = pack_bf16(r2.x + v0 * l2.x, r2.y + v1 * l2.y);
          }
          *reinterpret_cast<uint32_t*>(at) = packed;
        }
      }
      fence_proxy_async();
      named_sync(1 + half, 128);
      if (t == 0) {
#pragma unroll
        for (int a = 0; a < BN / 64; ++a)
          tma_store_2d(&map_out, stage_c + a * ATOM, tn * BN + a * 64, row0);
        tma_store_commit();
      }
    }
    if (t == 0) tma_store_wait_all();
  }
}

// The output tile width for an (m, n) GEMM: of the widths that divide n,
// the one whose waves over `sms` blocks cost the least (waves x BN), the
// wider on a tie (fewer re-reads of A).
int pick_bn(int m, int n, int sms) {
  const int widths[4] = {256, 192, 128, 64};
  int best = 0;
  long best_cost = 0;
  for (int bn : widths) {
    if (n % bn) continue;
    const long tiles = (long)((m + BM - 1) / BM) * (n / bn);
    const long cost = (tiles + sms - 1) / sms * bn;
    if (best == 0 || cost < best_cost) {
      best = bn;
      best_cost = cost;
    }
  }
  return best;
}

template <int BN, int EPI>
int launch_gemm(const void* a, const void* b, const void* bias, const void* res, const void* ls,
                void* out, int m, int n, int k, int sms, cudaStream_t st) {
  CUtensorMap map_a, map_b, map_out, map_res;
  const uint64_t dims_a[2] = {(uint64_t)k, (uint64_t)m}, dims_b[2] = {(uint64_t)k, (uint64_t)n};
  const uint64_t dims_c[2] = {(uint64_t)n, (uint64_t)m};
  const uint64_t stride_ab[1] = {(uint64_t)k * 2}, stride_c[1] = {(uint64_t)n * 2};
  const uint32_t box_a[2] = {BK, BM}, box_b[2] = {BK, BN}, box_c[2] = {64, 64};
  int err = encode_bf16_map(&map_a, a, 2, dims_a, stride_ab, box_a);
  if (!err) err = encode_bf16_map(&map_b, b, 2, dims_b, stride_ab, box_b);
  if (!err) err = encode_bf16_map(&map_out, out, 2, dims_c, stride_c, box_c);
  if (!err) err = encode_bf16_map(&map_res, EPI == DOWN_RESIDUAL ? res : out, 2, dims_c, stride_c, box_c);
  if (err) return err;
  constexpr int smem = smem_bytes<BN>();
  cudaError_t e = cudaFuncSetAttribute(mlp_gemm_kernel<BN, EPI>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int tiles = ((m + BM - 1) / BM) * (n / BN);
  mlp_gemm_kernel<BN, EPI><<<tiles < sms ? tiles : sms, THREADS, smem, st>>>(
      map_a, map_b, map_out, map_res, static_cast<const bf16*>(bias),
      static_cast<const bf16*>(ls), m, n, k);
  return static_cast<int>(cudaGetLastError());
}

template <int EPI>
int gemm(const void* a, const void* b, const void* bias, const void* res, const void* ls,
         void* out, int m, int n, int k, int sms, cudaStream_t st) {
  switch (pick_bn(m, n, sms)) {
    case 256:
      return launch_gemm<256, EPI>(a, b, bias, res, ls, out, m, n, k, sms, st);
    case 192:
      return launch_gemm<192, EPI>(a, b, bias, res, ls, out, m, n, k, sms, st);
    case 128:
      return launch_gemm<128, EPI>(a, b, bias, res, ls, out, m, n, k, sms, st);
    case 64:
      return launch_gemm<64, EPI>(a, b, bias, res, ls, out, m, n, k, sms, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// x, res, out: (rows, c); wu: (f, c); wd: (c, f); bu: (f,); bd, ls: (c,);
// h: (rows, f) scratch for the hidden. rows >= 1, c and f multiples of 64,
// every pointer 16-byte aligned (checked by the Python wrapper). Two
// launches on `stream`: the up-projection into h, then the down-projection.
extern "C" int s3od_mlp_fused(const void* x, const void* wu, const void* bu, const void* wd,
                              const void* bd, const void* res, const void* ls, void* out,
                              void* h, int rows, int c, int f, void* stream) {
  if (rows <= 0 || c <= 0 || f <= 0 || c % 64 != 0 || f % 64 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int sms = sm_count();
  const int err = gemm<UP_GELU>(x, wu, bu, nullptr, nullptr, h, rows, f, c, sms, st);
  if (err) return err;
  return gemm<DOWN_RESIDUAL>(h, wd, bd, res, ls, out, rows, c, f, sms, st);
}
