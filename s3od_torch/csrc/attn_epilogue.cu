// K4: attention epilogue — o_proj over the heads + bias, x layerscale,
// + residual, then LayerNorm(norm2) of the bf16-rounded new stream.
//
// Replaces the TPU kernel `s3od_tpu/ops/attn_epilogue.py:_kernel` (via
// `attn_epilogue`). Inputs: the attention output a in its head-major
// layout (B*H, N, D), the o_proj weight Wo (C, C) in nn.Linear layout
// [c_out][h*D + d], the residual x (B, N, C) and the bf16 vectors bo, ls1,
// norm2 weight / bias. Outputs, both (B, N, C) bf16:
//   x' = bf16(x + (sum_h a_h @ Wo_h^T + bo) * ls1)   (fp32 until the round)
//   h  = LayerNorm(x') with fp32 statistics of the ROUNDED x',
//        var = max(E[x'^2] - E[x']^2, 0).
//
// Bound on the H100: at ViT-B, 1024^2 the product is 2 x 4160 x 768^2 =
// 4.9 GFLOP over ~14 MB: compute-bound, but small. To keep the LayerNorm in
// the same pass a block must own whole rows: 32 rows x all C columns, 16
// warps (2 along rows x 8 along columns, each warp up to 16 n8 tiles of
// fp32 accumulators at C = 1024). A k-step of 32 copies the A rows straight
// from the head-major layout (a 32-wide k slice never straddles a head for
// D in {32, 64}, so no transpose copy is needed) and the (C x 32) slice of
// Wo, two stages deep in dynamic shared memory (up to 171 KB at C = 1024).
// After the loop the same shared memory holds the 32 x C fp32 tile of x'
// for the row statistics. Every block re-reads all of Wo (1.2 MB at ViT-B)
// from L2; larger row tiles or a split-K would cut that traffic.
#include "mma.cuh"

using namespace s3od;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BM = 32, BK = 32, LDK = BK + 8, THREADS = 512, MAXNT = 16;

__host__ __device__ constexpr int b_rows(int c) { return c + 16; }

size_t smem_bytes(int c) {
  return sizeof(bf16) * (2 * BM * LDK + 2 * (size_t)b_rows(c) * LDK);
}

__global__ void __launch_bounds__(THREADS)
    attn_epilogue_kernel(const bf16* __restrict__ a, const bf16* __restrict__ wo,
                         const bf16* __restrict__ bo, const bf16* __restrict__ x,
                         const bf16* __restrict__ ls, const bf16* __restrict__ lw,
                         const bf16* __restrict__ lb, bf16* __restrict__ xn,
                         bf16* __restrict__ hout, int n, int c, int heads, int d,
                         float eps) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sA = reinterpret_cast<bf16*>(smem);  // [2][BM][LDK]
  bf16* sB = sA + 2 * BM * LDK;               // [2][b_rows(c)][LDK]
  float* sX = reinterpret_cast<float*>(sB);   // [BM][c + 8], after the loop
  const int ldx = c + 8;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 1, wn = warp >> 1;
  const int row0 = blockIdx.x * BM;
  const int ncols = c / 8;   // columns owned by one warp
  const int nt = ncols / 8;  // its n8 tiles, 1..MAXNT
  const int colw = wn * ncols;
  const int bstage = b_rows(c) * LDK;

  auto load_stage = [&](int stage, int k0) {
    const int h = k0 / d, d0 = k0 - h * d;
    for (int i = tid; i < BM * (BK / 8); i += THREADS) {
      const int r = i >> 2, cc = (i & 3) * 8;
      const int row = row0 + r;
      const int bb = row / n, tok = row - bb * n;
      cp_async16(sA + (stage * BM + r) * LDK + cc,
                 a + (((size_t)bb * heads + h) * n + tok) * d + d0 + cc);
    }
    for (int i = tid; i < c * (BK / 8); i += THREADS) {
      const int r = i >> 2, cc = (i & 3) * 8;
      cp_async16(sB + stage * bstage + r * LDK + cc, wo + (size_t)r * c + k0 + cc);
    }
    cp_async_commit();
  };

  float acc[MAXNT][4];
#pragma unroll
  for (int i = 0; i < MAXNT; ++i)
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
    const bf16* sa = sA + (kt & 1) * BM * LDK;
    const bf16* sb = sB + (kt & 1) * bstage;
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      uint32_t af[4];
      load_a_frag(af, sa + wm * 16 * LDK + ks * 16, LDK, lane);
#pragma unroll
      for (int np = 0; np < MAXNT / 2; ++np) {
        if (2 * np < nt) {
          // An odd tile count reads 8 rows past the warp's columns (at
          // most into the b_rows pad); those products are discarded.
          uint32_t bf[4];
          load_b_frag_nk(bf, sb + (colw + np * 16) * LDK + ks * 16, LDK, lane);
          mma_bf16(acc[2 * np], af, bf[0], bf[1]);
          if (2 * np + 1 < nt) mma_bf16(acc[2 * np + 1], af, bf[2], bf[3]);
        }
      }
    }
    __syncthreads();
  }

  // x' = bf16(x + (acc + bo) * ls), staged in fp32 for the statistics.
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < MAXNT; ++j) {
    if (j < nt) {
      const int col = colw + j * 8 + 2 * t;
      const float bo0 = __bfloat162float(bo[col]), bo1 = __bfloat162float(bo[col + 1]);
      const float ls0 = __bfloat162float(ls[col]), ls1 = __bfloat162float(ls[col + 1]);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int rl = wm * 16 + g + 8 * half;
        const __nv_bfloat162 xr =
            *reinterpret_cast<const __nv_bfloat162*>(x + (size_t)(row0 + rl) * c + col);
        const float v0 = __bfloat162float(xr.x) + (acc[j][2 * half] + bo0) * ls0;
        const float v1 = __bfloat162float(xr.y) + (acc[j][2 * half + 1] + bo1) * ls1;
        sX[rl * ldx + col] = __bfloat162float(__float2bfloat16_rn(v0));
        sX[rl * ldx + col + 1] = __bfloat162float(__float2bfloat16_rn(v1));
      }
    }
  }
  __syncthreads();

  // LayerNorm: each warp finishes BM / 16 = 2 whole rows.
  for (int rr = 0; rr < BM / 16; ++rr) {
    const int rl = warp * (BM / 16) + rr;
    const float* xs = sX + rl * ldx;
    float s1 = 0.f, s2 = 0.f;
    for (int cc = 2 * lane; cc < c; cc += 64) {
      const float v0 = xs[cc], v1 = xs[cc + 1];
      s1 += v0 + v1;
      s2 += v0 * v0 + v1 * v1;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      s1 += __shfl_xor_sync(0xffffffff, s1, off);
      s2 += __shfl_xor_sync(0xffffffff, s2, off);
    }
    const float m1 = s1 / c, m2 = s2 / c;
    const float rstd = rsqrtf(fmaxf(m2 - m1 * m1, 0.f) + eps);
    const size_t rowoff = (size_t)(row0 + rl) * c;
    for (int cc = 2 * lane; cc < c; cc += 64) {
      const float v0 = xs[cc], v1 = xs[cc + 1];
      *reinterpret_cast<__nv_bfloat162*>(xn + rowoff + cc) = __floats2bfloat162_rn(v0, v1);
      const float y0 = (v0 - m1) * rstd * __bfloat162float(lw[cc]) + __bfloat162float(lb[cc]);
      const float y1 =
          (v1 - m1) * rstd * __bfloat162float(lw[cc + 1]) + __bfloat162float(lb[cc + 1]);
      *reinterpret_cast<__nv_bfloat162*>(hout + rowoff + cc) = __floats2bfloat162_rn(y0, y1);
    }
  }
}

}  // namespace

// a: (batch*heads, n, d); wo: (c, c); x, xn, h: (batch, n, c); vectors (c,).
// n a multiple of 64, c a multiple of 64 up to 1024, d in {32, 64}
// (checked by the Python wrapper).
extern "C" int s3od_attn_epilogue(const void* a, const void* wo, const void* bo,
                                  const void* x, const void* ls, const void* lw,
                                  const void* lb, void* xn, void* h, int batch, int n,
                                  int c, int heads, int d, float eps, void* stream) {
  if (c % 64 != 0 || c > 8 * 8 * MAXNT || (d != 32 && d != 64))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = smem_bytes(c);
  cudaError_t err = cudaFuncSetAttribute(
      attn_epilogue_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(batch * n / BM);
  attn_epilogue_kernel<<<grid, THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(a), static_cast<const bf16*>(wo),
      static_cast<const bf16*>(bo), static_cast<const bf16*>(x),
      static_cast<const bf16*>(ls), static_cast<const bf16*>(lw),
      static_cast<const bf16*>(lb), static_cast<bf16*>(xn), static_cast<bf16*>(h), n, c,
      heads, d, eps);
  return static_cast<int>(cudaGetLastError());
}
