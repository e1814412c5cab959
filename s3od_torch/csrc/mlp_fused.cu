// K5: fused ViT MLP — up-proj + bias, erf-GELU, down-proj + bias,
// x layerscale, + residual, with the (rows, F) hidden kept on chip.
//
// Replaces the TPU kernel `s3od_tpu/ops/mlp_fused.py:_kernel` (via
// `mlp_fused` <- `vit_block`). Inputs: x = LayerNorm_norm2(stream) and the
// residual r, both (rows, C) bf16; Wu (F, C) and Wd (C, F) in nn.Linear
// layout (row-major (n, k): both are B operands read k-contiguous, no
// transpose); bf16 vectors bu (F,), bd and ls (C,). Output (rows, C) bf16:
//   h   = bf16(gelu_erf(x @ Wu^T + bu))        fp32 accumulate, GELU on fp32
//   out = bf16(r + (h @ Wd^T + bd) * ls)       fp32 until the one rounding
// — the TPU kernel's rounding points exactly. GELU uses CUDA's erff
// (<= 2 ulp); the TPU kernel's rational erf differs from it by <= 1.5e-7.
//
// Bound on the H100: at ViT-B, 1024^2 the two products are 2 x 2 x 4160 x
// 768 x 3072 = 39 GFLOP, and the point of the kernel is that the 4160 x
// 3072 hidden (25.6 MB in bf16, written and read back by the unfused MLP)
// never reaches device memory. The scarce resource is the fp32 (rows x C)
// output accumulator, which must stay on chip across the whole F loop: a
// block owns 32 rows x all C columns with 16 warps (2 along rows x 8 along
// columns; 32 x 768 fp32 is 48 registers a thread). Every block re-reads
// both weights (9.4 MB at ViT-B) from the 50 MB L2, but that traffic is not
// what bounds it: a variant in which a two-block cluster shared each weight
// tile (half the L2 bytes) ran no faster on an H100. The bound is latency —
// three barriers per 32-column chunk, a prefetch that covers half a chunk,
// warp-level mma.sync — at ~5x the tensor-core time; a warp-specialised
// wgmma pipeline with deeper weight buffering is the next step.
//
// Per F chunk of 32 hidden columns:
//   1. up-proj: H (32 x 32) = X @ Wu_chunk^T, X resident in shared memory;
//      16 warps = 2 row halves x 4 n8 tiles x 2 halves of K, partials
//      through shared memory;
//   2. reduce the two K halves, + bu, GELU, round to bf16 -> sH;
//   3. down-proj: acc (32 x C) += sH @ Wd_chunk^T, in registers.
// Wu_{i+1} streams in (cp.async) while steps 2-3 of chunk i run, and
// Wd_{i+1} while step 1 of chunk i+1 runs. Shared memory: X, one Wu chunk,
// one Wd chunk, the partials and sH = 208 C + 15 KB (175 KB at C = 768,
// 223 KB at C = 1024).
#include "mma.cuh"

using namespace s3od;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BM = 32, BF = 32, THREADS = 512;
constexpr int LDF = BF + 8;  // bf16 row stride of the Wd chunk and of sH
constexpr int LDP = BF + 8;  // fp32 row stride of the partials

__host__ __device__ constexpr int ldx(int c) { return c + 8; }
// An odd n8-tile count per warp reads 8 rows past its columns (see K4).
__host__ __device__ constexpr int wd_rows(int c) { return c + 16; }

size_t smem_bytes(int c) {
  return sizeof(bf16) * (2 * (size_t)BM * ldx(c) + (size_t)wd_rows(c) * LDF + BM * LDF) +
         sizeof(float) * 2 * BM * LDP;
}

__device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
}

// B fragments of ONE n8 tile over 32 k (two k16 steps) from an (n, k)
// tile: b[0], b[1] for k 0..15 and b[2], b[3] for k 16..31.
__device__ __forceinline__ void load_b_frag_nk_k32(uint32_t b[4], const bf16* tile, int ld,
                                                   int lane) {
  ldmatrix_x4(b, tile + (lane & 7) * ld + (lane >> 3) * 8);
}

template <int MAXNT>
__global__ void __launch_bounds__(THREADS)
    mlp_fused_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wu,
                     const bf16* __restrict__ bu, const bf16* __restrict__ wd,
                     const bf16* __restrict__ bd, const bf16* __restrict__ res,
                     const bf16* __restrict__ ls, bf16* __restrict__ out, int c, int f) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lx = ldx(c);
  bf16* sX = reinterpret_cast<bf16*>(smem);  // [BM][lx]
  bf16* sWu = sX + BM * lx;                   // [BF][lx]
  bf16* sWd = sWu + BF * lx;                  // [wd_rows(c)][LDF]
  bf16* sH = sWd + wd_rows(c) * LDF;          // [BM][LDF]
  float* sP = reinterpret_cast<float*>(sH + BM * LDF);  // [2][BM][LDP]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const size_t row0 = (size_t)blockIdx.x * BM;
  const int kch = c / 8;  // 16-byte chunks per row of X / Wu

  auto load_x = [&]() {
    for (int i = tid; i < BM * kch; i += THREADS) {
      const int r = i / kch, cc = (i - r * kch) * 8;
      cp_async16(sX + r * lx + cc, x + (row0 + r) * c + cc);
    }
  };
  auto load_wu = [&](int f0) {
    for (int i = tid; i < BF * kch; i += THREADS) {
      const int r = i / kch, cc = (i - r * kch) * 8;
      cp_async16(sWu + r * lx + cc, wu + (size_t)(f0 + r) * c + cc);
    }
  };
  auto load_wd = [&](int f0) {
    for (int i = tid; i < c * (BF / 8); i += THREADS) {
      const int r = i >> 2, cc = (i & 3) * 8;
      cp_async16(sWd + r * LDF + cc, wd + (size_t)r * f + f0 + cc);
    }
  };

  // Down-proj / output mapping: rows wm*16.., columns colw.. (nt n8 tiles).
  const int wm = warp & 1, wn = warp >> 1;
  const int nt = c / 64;
  const int colw = wn * (c / 8);
  // Up-proj mapping: rows um*16.., hidden columns un*8.., K half uk.
  const int um = warp & 1, un = (warp >> 1) & 3, uk = warp >> 3;
  const int khalf = c / 2;

  float acc[MAXNT][4];
#pragma unroll
  for (int i = 0; i < MAXNT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  const int nf = f / BF;
  load_x();
  load_wu(0);
  cp_async_commit();
  load_wd(0);
  cp_async_commit();

  for (int fi = 0; fi < nf; ++fi) {
    const int f0 = fi * BF;
    cp_async_wait<1>();  // X and Wu_fi have landed (Wd_fi may be in flight)
    __syncthreads();

    // 1. up-proj partial over one K half
    {
      float p[4] = {0.f, 0.f, 0.f, 0.f};
      const bf16* xa = sX + um * 16 * lx + uk * khalf;
      const bf16* wb = sWu + un * 8 * lx + uk * khalf;
      for (int k0 = 0; k0 < khalf; k0 += 32) {
        uint32_t a0[4], a1[4], b[4];
        load_a_frag(a0, xa + k0, lx, lane);
        load_a_frag(a1, xa + k0 + 16, lx, lane);
        load_b_frag_nk_k32(b, wb + k0, lx, lane);
        mma_bf16(p, a0, b[0], b[1]);
        mma_bf16(p, a1, b[2], b[3]);
      }
      float* sp = sP + uk * BM * LDP;
      const int col = un * 8 + 2 * t;
      *reinterpret_cast<float2*>(sp + (um * 16 + g) * LDP + col) = make_float2(p[0], p[1]);
      *reinterpret_cast<float2*>(sp + (um * 16 + g + 8) * LDP + col) = make_float2(p[2], p[3]);
    }
    __syncthreads();  // partials complete; sWu is free

    if (fi + 1 < nf) load_wu(f0 + BF);
    cp_async_commit();  // (an empty group on the last chunk)

    // 2. reduce the K halves, + bu, GELU on fp32, round once to bf16
    {
      const int e = tid * 2, r = e / BF, col = e % BF;
      const float2 p0 = *reinterpret_cast<const float2*>(sP + r * LDP + col);
      const float2 p1 = *reinterpret_cast<const float2*>(sP + (BM + r) * LDP + col);
      const __nv_bfloat162 bb = *reinterpret_cast<const __nv_bfloat162*>(bu + f0 + col);
      const float h0 = gelu_erf(p0.x + p1.x + __bfloat162float(bb.x));
      const float h1 = gelu_erf(p0.y + p1.y + __bfloat162float(bb.y));
      *reinterpret_cast<__nv_bfloat162*>(sH + r * LDF + col) = __floats2bfloat162_rn(h0, h1);
    }
    cp_async_wait<1>();  // Wd_fi has landed (Wu_fi+1 may be in flight)
    __syncthreads();

    // 3. down-proj: acc += sH (rows wm*16..) @ Wd_chunk^T (columns colw..)
#pragma unroll
    for (int ks = 0; ks < BF / 16; ++ks) {
      uint32_t af[4];
      load_a_frag(af, sH + wm * 16 * LDF + ks * 16, LDF, lane);
#pragma unroll
      for (int np = 0; np < MAXNT / 2; ++np) {
        if (2 * np < nt) {
          uint32_t bfr[4];
          load_b_frag_nk(bfr, sWd + (colw + np * 16) * LDF + ks * 16, LDF, lane);
          mma_bf16(acc[2 * np], af, bfr[0], bfr[1]);
          if (2 * np + 1 < nt) mma_bf16(acc[2 * np + 1], af, bfr[2], bfr[3]);
        }
      }
    }
    __syncthreads();  // sWd and sH are free

    if (fi + 1 < nf) load_wd(f0 + BF);
    cp_async_commit();
  }

  // out = bf16(r + (acc + bd) * ls)
#pragma unroll
  for (int j = 0; j < MAXNT; ++j) {
    if (j < nt) {
      const int col = colw + j * 8 + 2 * t;
      const __nv_bfloat162 b2 = *reinterpret_cast<const __nv_bfloat162*>(bd + col);
      const __nv_bfloat162 l2 = *reinterpret_cast<const __nv_bfloat162*>(ls + col);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const size_t off = (row0 + wm * 16 + g + 8 * half) * c + col;
        const __nv_bfloat162 r2 = *reinterpret_cast<const __nv_bfloat162*>(res + off);
        const float v0 = __bfloat162float(r2.x) +
                         (acc[j][2 * half] + __bfloat162float(b2.x)) * __bfloat162float(l2.x);
        const float v1 = __bfloat162float(r2.y) +
                         (acc[j][2 * half + 1] + __bfloat162float(b2.y)) * __bfloat162float(l2.y);
        *reinterpret_cast<__nv_bfloat162*>(out + off) = __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

template <int MAXNT>
int launch(const void* x, const void* wu, const void* bu, const void* wd, const void* bd,
           const void* res, const void* ls, void* out, int rows, int c, int f,
           cudaStream_t st) {
  const size_t bytes = smem_bytes(c);
  cudaError_t err = cudaFuncSetAttribute(
      mlp_fused_kernel<MAXNT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  mlp_fused_kernel<MAXNT><<<rows / BM, THREADS, bytes, st>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(wu),
      static_cast<const bf16*>(bu), static_cast<const bf16*>(wd),
      static_cast<const bf16*>(bd), static_cast<const bf16*>(res),
      static_cast<const bf16*>(ls), static_cast<bf16*>(out), c, f);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, res, out: (rows, c); wu: (f, c); wd: (c, f); bu: (f,); bd, ls: (c,).
// rows a multiple of 32, c a multiple of 64 up to 1024, f a multiple of 32
// (checked by the Python wrapper).
extern "C" int s3od_mlp_fused(const void* x, const void* wu, const void* bu, const void* wd,
                              const void* bd, const void* res, const void* ls, void* out,
                              int rows, int c, int f, void* stream) {
  if (rows % BM != 0 || c % 64 != 0 || c > 1024 || f % BF != 0 || f <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nt = c / 64;
  if (nt <= 4) return launch<4>(x, wu, bu, wd, bd, res, ls, out, rows, c, f, st);
  if (nt <= 8) return launch<8>(x, wu, bu, wd, bd, res, ls, out, rows, c, f, st);
  if (nt <= 12) return launch<12>(x, wu, bu, wd, bd, res, ls, out, rows, c, f, st);
  return launch<16>(x, wu, bu, wd, bd, res, ls, out, rows, c, f, st);
}
