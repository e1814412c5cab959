// K2: fused QKV projection + RoPE, head-major output.
//
// Replaces the TPU kernel `s3od_tpu/ops/qkv_project.py:_kernel` (via
// `qkv_project_rope`). For x (rows = B*N, C) and the fused nn.Linear-layout
// weight W (3C, C) it computes y = x @ W^T + b with fp32 accumulation and,
// in the epilogue:
//   - q, k: y * cos + rot(bf16(y)) * sin in fp32, where rot is rotate-half
//     of the bf16-ROUNDED y (the TPU kernel rotates with a +-1 bf16 matmul
//     on the rounded y, `qkv_project.py:94-99`);
//   - q additionally * D^-1/2 in fp32, so attention runs with scale 1;
//   - bf16 stores straight into the (B, H, N, D) layout K3 reads.
// The TPU's head-pair packing is a lane layout and is not ported.
//
// Bound on the H100: at ViT-B, 1024^2 (M = 4160, K = 768, N = 2304) this is
// a 14.7 GFLOP product over ~10 MB of operands, compute-bound (~1400
// FLOP/byte). The design is a simple 64x64x64 tile with a two-stage
// cp.async pipeline feeding mma.sync; each 64-column output tile is one
// whole head (or two heads at D = 32), so the rotate-half partner column is
// inside the tile and is read back from shared memory.
#include "mma.cuh"

using namespace s3od;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BM = 64, BN = 64, BK = 64, LDS = BK + 8, THREADS = 128;

__global__ void __launch_bounds__(THREADS)
    qkv_rope_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                    const bf16* __restrict__ bias, const float* __restrict__ cos_t,
                    const float* __restrict__ sin_t, bf16* __restrict__ q,
                    bf16* __restrict__ k, bf16* __restrict__ v, int n, int c, int heads,
                    int d, float scale) {
  __shared__ __align__(16) bf16 sA[2][BM][LDS];
  __shared__ __align__(16) bf16 sB[2][BN][LDS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row0 = blockIdx.x * BM;
  const int col0 = blockIdx.y * BN;  // column in [0, 3C)
  const bf16* xa = x + (size_t)row0 * c;
  const bf16* wb = w + (size_t)col0 * c;

  auto load_stage = [&](int stage, int k0) {
    for (int i = tid; i < BM * (BK / 8); i += THREADS) {
      const int r = i >> 3, cc = (i & 7) * 8;
      cp_async16(&sA[stage][r][cc], xa + (size_t)r * c + k0 + cc);
      cp_async16(&sB[stage][r][cc], wb + (size_t)r * c + k0 + cc);
    }
    cp_async_commit();
  };

  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  const int nk = c / BK;
  load_stage(0, 0);
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) {
      load_stage((kt + 1) & 1, (kt + 1) * BK);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int s = kt & 1;
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      uint32_t a[4];
      load_a_frag(a, &sA[s][warp * 16][ks * 16], LDS, lane);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t b[4];
        load_b_frag_nk(b, &sB[s][np * 16][ks * 16], LDS, lane);
        mma_bf16(acc[2 * np], a, b[0], b[1]);
        mma_bf16(acc[2 * np + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();
  }

  const int g = lane >> 2, t = lane & 3;
  const int seg = col0 / c;         // 0 = q, 1 = k, 2 = v
  const int cseg = col0 - seg * c;  // first column of the tile inside its segment
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int j = nt * 8 + 2 * t;
    const float b0 = __bfloat162float(bias[col0 + j]);
    const float b1 = __bfloat162float(bias[col0 + j + 1]);
    acc[nt][0] += b0;
    acc[nt][1] += b1;
    acc[nt][2] += b0;
    acc[nt][3] += b1;
  }

  // bf16(y) of the whole tile, for the rotate-half partner reads.
  bf16(*sY)[LDS] = sA[0];
  if (seg < 2) {
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int j = nt * 8 + 2 * t;
      const int r = warp * 16 + g;
      *reinterpret_cast<uint32_t*>(&sY[r][j]) = pack_bf16(acc[nt][0], acc[nt][1]);
      *reinterpret_cast<uint32_t*>(&sY[r + 8][j]) = pack_bf16(acc[nt][2], acc[nt][3]);
    }
    __syncthreads();
  }

  bf16* out = seg == 0 ? q : (seg == 1 ? k : v);
  const int half_d = d / 2;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int j = nt * 8 + 2 * t;  // column inside the tile (even)
    const int cc = cseg + j;
    const int h = cc / d, jh = cc - h * d;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int rl = warp * 16 + g + 8 * half;
      const int r = row0 + rl;
      const int bb = r / n, tok = r - bb * n;
      float y0 = acc[nt][2 * half], y1 = acc[nt][2 * half + 1];
      if (seg < 2) {
        const bool lo = jh < half_d;
        const int partner = lo ? j + half_d : j - half_d;
        const float sign = lo ? -1.f : 1.f;
        const float r0 = sign * __bfloat162float(sY[rl][partner]);
        const float r1 = sign * __bfloat162float(sY[rl][partner + 1]);
        const float* ct = cos_t + (size_t)tok * d + jh;
        const float* st = sin_t + (size_t)tok * d + jh;
        y0 = y0 * ct[0] + r0 * st[0];
        y1 = y1 * ct[1] + r1 * st[1];
        if (seg == 0) {
          y0 *= scale;
          y1 *= scale;
        }
      }
      const size_t off = (((size_t)bb * heads + h) * n + tok) * d + jh;
      *reinterpret_cast<uint32_t*>(out + off) = pack_bf16(y0, y1);
    }
  }
}

}  // namespace

// rows = B * n must be a multiple of 64, n a multiple of 64, c a multiple of
// 64, d in {32, 64} (checked by the Python wrapper).
extern "C" int s3od_qkv_project_rope(const void* x, const void* w, const void* b,
                                     const void* cos_t, const void* sin_t, void* q,
                                     void* k, void* v, int rows, int n, int c, int heads,
                                     int d, float scale, void* stream) {
  dim3 grid(rows / BM, 3 * c / BN);
  qkv_rope_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<const bf16*>(b), static_cast<const float*>(cos_t),
      static_cast<const float*>(sin_t), static_cast<bf16*>(q), static_cast<bf16*>(k),
      static_cast<bf16*>(v), n, c, heads, d, scale);
  return static_cast<int>(cudaGetLastError());
}
