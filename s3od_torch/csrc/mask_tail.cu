// K10: the fused mask-head tail at the full canvas,
//   h1  = bf16(relu(conv3x3(relu(x), w1) + b1))   zero outside the image
//   h2  = bf16(relu(conv3x3(h1, w0) + b0))
//   out = bf16(h2 @ k1 + bk)
// with x the mask head's transposed-conv output (before its ReLU), C_in =
// 64 -> 64 -> C_mid = 96 (3 branches x 32) -> 3 masks at ViT-B/L.
//
// Replaces the TPU kernel `s3od_tpu/ops/experimental/mask_tail.py:_kernel`
// (via `mask_tail`). x is (B, H, W, C_in) in NHWC *logical* order with any
// strides (the decoder passes NCHW memory: W-contiguous rows), weights HWIO
// ([tap][c_in][c_out] is the B operand's k-major layout as stored), out
// (B, H, W, n_out) through strides. The rounding points are the TPU
// kernel's: fp32 accumulation, each bias added in fp32 before the one
// rounding of its layer, h1's ring masked to zero after the ReLU.
//
// What bounds it on the H100: at 1024^2 the two convs are 7.7e10 + 1.16e11
// FLOP (~0.2 ms on the tensor cores) over 134 MB of input (~0.04 ms): the
// operations. The point of the fusion is that h1 and h2 (each 128-192 MB
// per 1024^2 image in bf16 as separate ops) never reach device memory.
//
// Design: one block per (image, 4 output rows, 62 output columns), 8
// warps. The ReLU'd input slab with its 2-pixel halo (8 x 66 pixels x
// C_in, channels minor) and w1 go to shared memory — the slab by cp.async
// of 8 channels a pixel when x is NHWC memory, by 16-byte row chunks
// staged through registers when it is NCHW; conv1 is an implicit GEMM over
// the 6 x 64 h1 positions (the 1-pixel halo conv2 needs; 1.55x conv2's
// positions), M = pixels, N = C_in, K = 9 taps x C_in, with mma.sync and
// per-lane ldmatrix row addresses (a row of A is one pixel's channels, so
// any pixel set is a valid M tile); each warp takes 3 m16 tiles and shares
// every w1 fragment among them. h1 stays in shared memory; w0 then
// overwrites the slab and w1, and conv2 runs the same way (N = C_mid, two
// m16 tiles a warp). Its epilogue rounds h2 to bf16 in registers, takes
// the 1x1 to n_out as per-thread partial dots reduced across the quad of
// lanes that share a pixel, and writes only the n_out masks. 211 KB of
// shared memory at C_in = 64: one block an SM, so a block's loads are not
// overlapped with its products, and every block reloads the 184 KB of
// weights from L2 — the next things to change for speed.
#include "mma.cuh"

using namespace s3od;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int THREADS = 256;
// 62 columns make h1 6 x 64: 24 m16 tiles, 3 for each of the 8 warps.
constexpr int TRW = 4, TCOL = 62;           // output rows and columns of a block
constexpr int SR = TRW + 4, SC = TCOL + 4;  // the input slab: 8 x 66
constexpr int HR = TRW + 2, HC = TCOL + 2;  // h1: 6 x 64
constexpr int MT1 = HR * HC / 16 / 8;       // h1 m16 tiles of a warp: 3
constexpr int M2 = TRW * TCOL;              // output pixels: 248
constexpr int MT2 = 2;                      // their m16 tiles of a warp (16 x 16 >= 248)
constexpr int MAXO = 4;                     // n_out at most
static_assert(HR * HC == MT1 * 16 * 8 && MT2 * 16 * 8 >= M2, "block shape");

struct Strides {
  long long b, h, w, c;
};

template <int CIN, int CMID>
struct Layout {
  static constexpr int LDI = CIN + 8;   // bf16 stride of a slab / h1 pixel
  static constexpr int LDW1 = CIN + 8;  // w1: [9][CIN][LDW1]
  static constexpr int LDW0 = CMID + 8; // w0: [9][CIN][LDW0]
  static constexpr size_t H1 = (size_t)HR * HC * LDI;
  static constexpr size_t SLAB = (size_t)SR * SC * LDI;
  static constexpr size_t W1 = (size_t)9 * CIN * LDW1;
  static constexpr size_t W0 = (size_t)9 * CIN * LDW0;
  static constexpr size_t PHASE = SLAB + W1 > W0 ? SLAB + W1 : W0;
  static constexpr size_t BYTES =
      sizeof(bf16) * (H1 + PHASE) + sizeof(float) * (CMID * MAXO + CMID + CIN + MAXO);
};

// How a block reads its slab of x: element by element (any strides), in
// 16-byte row chunks of one channel (NCHW memory), or in 16-byte chunks of
// 8 channels of one pixel (NHWC memory).
enum : int { BY_ELEMENT = 0, BY_ROW = 1, BY_PIXEL = 2 };

int load_mode(const void* x, int w, const Strides& xs) {
  const bool aligned =
      reinterpret_cast<uintptr_t>(x) % 16 == 0 && xs.h % 8 == 0 && xs.b % 8 == 0;
  if (aligned && xs.w == 1 && w % 8 == 0 && xs.c % 8 == 0) return BY_ROW;
  if (aligned && xs.c == 1 && xs.w % 8 == 0) return BY_PIXEL;
  return BY_ELEMENT;
}

// 16-byte global -> shared copy that fills zeros when `bytes` is 0.
__device__ __forceinline__ void cp_async16_zfill(void* smem, const void* gmem, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(smem)),
               "l"(gmem), "r"(bytes));
}

template <int CIN, int CMID, int MODE>
__global__ void __launch_bounds__(THREADS)
    mask_tail_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                     const bf16* __restrict__ b1, const bf16* __restrict__ w0,
                     const bf16* __restrict__ b0, const bf16* __restrict__ k1,
                     const bf16* __restrict__ bk, bf16* __restrict__ out, int h, int w, int nout,
                     Strides xs, Strides os) {
  using L = Layout<CIN, CMID>;
  constexpr int NT1 = CIN / 8, NT2 = CMID / 8;
  static_assert(CIN % 16 == 0 && CMID % 16 == 0, "whole k16 steps and n8 pairs");
  extern __shared__ __align__(16) unsigned char smem[];
  // h1: pixel (i, j) <-> image (r0 - 1 + i, c0 - 1 + j); slab: (i, j) <->
  // (r0 - 2 + i, c0 - 2 + j); channels contiguous.
  bf16* s_h1 = reinterpret_cast<bf16*>(smem);
  bf16* s_slab = s_h1 + L::H1;
  bf16* s_w1 = s_slab + L::SLAB;
  bf16* s_w0 = s_slab;  // conv2's phase: over the slab and w1
  float* s_k1 = reinterpret_cast<float*>(smem + sizeof(bf16) * (L::H1 + L::PHASE));  // [CMID][MAXO]
  float* s_b0 = s_k1 + CMID * MAXO;
  float* s_b1 = s_b0 + CMID;
  float* s_bk = s_b1 + CIN;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = blockIdx.y * TRW, c0 = blockIdx.x * TCOL;
  const bf16* xb = x + blockIdx.z * xs.b;

  for (int i = tid; i < 9 * CIN * (CIN / 8); i += THREADS) {
    const int row = i / (CIN / 8), seg = i - row * (CIN / 8);
    cp_async16(s_w1 + row * L::LDW1 + seg * 8, w1 + (size_t)row * CIN + seg * 8);
  }
  cp_async_commit();
  for (int i = tid; i < CMID * MAXO; i += THREADS) {
    const int m = i / MAXO, o = i - m * MAXO;
    s_k1[i] = o < nout ? __bfloat162float(k1[m * nout + o]) : 0.f;
  }
  for (int i = tid; i < CMID; i += THREADS) s_b0[i] = __bfloat162float(b0[i]);
  for (int i = tid; i < CIN; i += THREADS) s_b1[i] = __bfloat162float(b1[i]);
  if (tid < MAXO) s_bk[tid] = tid < nout ? __bfloat162float(bk[tid]) : 0.f;
  // The ReLU'd slab, zero outside the image. BY_PIXEL: cp.async straight
  // into the channel-minor slab, then the ReLU in place. BY_ROW: 16-byte
  // row chunks (8 columns of one channel) staged through registers,
  // neighbouring lanes on neighbouring channels so that the channel-minor
  // stores hit distinct banks. BY_ELEMENT: element by element.
  if (MODE == BY_PIXEL) {
    for (int i = tid; i < SR * SC * (CIN / 8); i += THREADS) {
      const int q = i % (CIN / 8), pix = i / (CIN / 8);
      const int r = pix / SC, j = pix - r * SC;
      const int gy = r0 - 2 + r, gx = c0 - 2 + j;
      const bool in = gy >= 0 && gy < h && gx >= 0 && gx < w;
      const bf16* src = in ? xb + gy * xs.h + gx * xs.w + q * 8 : xb;
      cp_async16_zfill(s_slab + pix * L::LDI + q * 8, src, in ? 16 : 0);
    }
    cp_async_commit();
  } else if (MODE == BY_ROW) {
    constexpr int NCH = (7 + SC + 7) / 8;
    const int xa = (c0 - 2) & ~7;
#pragma unroll 4
    for (int i = tid; i < CIN * SR * NCH; i += THREADS) {
      const int ci = i % CIN, rest = i / CIN;
      const int r = rest / NCH, q = rest - r * NCH;
      const int gy = r0 - 2 + r, gx = xa + q * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (gy >= 0 && gy < h && gx >= 0 && gx < w)
        v = *reinterpret_cast<const uint4*>(xb + gy * xs.h + gx + ci * xs.c);
      const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = gx + j - (c0 - 2);
        if (col >= 0 && col < SC)
          s_slab[(r * SC + col) * L::LDI + ci] =
              __float2bfloat16(fmaxf(__bfloat162float(e[j]), 0.f));
      }
    }
  } else {
    for (int i = tid; i < CIN * SR * SC; i += THREADS) {
      const int ci = i / (SR * SC), rem = i - ci * (SR * SC);
      const int r = rem / SC, s = rem - r * SC;
      const int gy = r0 - 2 + r, gx = c0 - 2 + s;
      float v = 0.f;
      if (gy >= 0 && gy < h && gx >= 0 && gx < w)
        v = fmaxf(__bfloat162float(xb[gy * xs.h + gx * xs.w + ci * xs.c]), 0.f);
      s_slab[(r * SC + s) * L::LDI + ci] = __float2bfloat16(v);
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  if (MODE == BY_PIXEL) {
    const __nv_bfloat162 zero = __floats2bfloat162_rn(0.f, 0.f);
    for (int i = tid; i < SR * SC * (CIN / 8); i += THREADS) {
      uint4* p = reinterpret_cast<uint4*>(s_slab + (i / (CIN / 8)) * L::LDI + (i % (CIN / 8)) * 8);
      uint4 v = *p;
      __nv_bfloat162* e = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
      for (int j = 0; j < 4; ++j) e[j] = __hmax2(e[j], zero);
      *p = v;
    }
    __syncthreads();
  }

  // conv1 -> h1: MT1 m16 tiles of h1 positions a warp, sharing each w1
  // fragment among them
  {
    float acc[MT1][NT1][4];
    const bf16* arow[MT1];
#pragma unroll
    for (int mi = 0; mi < MT1; ++mi) {
      const int m = (warp * MT1 + mi) * 16 + (lane & 15);
      arow[mi] = s_slab + ((m / HC) * SC + m % HC) * L::LDI + (lane >> 4) * 8;
#pragma unroll
      for (int n = 0; n < NT1; ++n)
        acc[mi][n][0] = acc[mi][n][1] = acc[mi][n][2] = acc[mi][n][3] = 0.f;
    }
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int off = ((tap / 3) * SC + tap % 3) * L::LDI;
#pragma unroll
      for (int kc = 0; kc < CIN; kc += 16) {
        uint32_t a[MT1][4];
#pragma unroll
        for (int mi = 0; mi < MT1; ++mi) ldmatrix_x4(a[mi], arow[mi] + off + kc);
#pragma unroll
        for (int np = 0; np < NT1 / 2; ++np) {
          uint32_t b[4];
          load_b_frag_kn(b, s_w1 + (tap * CIN + kc) * L::LDW1 + np * 16, L::LDW1, lane);
#pragma unroll
          for (int mi = 0; mi < MT1; ++mi) {
            mma_bf16(acc[mi][2 * np], a[mi], b[0], b[1]);
            mma_bf16(acc[mi][2 * np + 1], a[mi], b[2], b[3]);
          }
        }
      }
    }
#pragma unroll
    for (int mi = 0; mi < MT1; ++mi)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = (warp * MT1 + mi) * 16 + g + half * 8;
        const int hi = m / HC, hj = m % HC;
        const int gy = r0 - 1 + hi, gx = c0 - 1 + hj;
        const bool inside = gy >= 0 && gy < h && gx >= 0 && gx < w;
#pragma unroll
        for (int n = 0; n < NT1; ++n) {
          const int col = n * 8 + 2 * t;
          const float v0 = inside ? fmaxf(acc[mi][n][2 * half] + s_b1[col], 0.f) : 0.f;
          const float v1 = inside ? fmaxf(acc[mi][n][2 * half + 1] + s_b1[col + 1], 0.f) : 0.f;
          *reinterpret_cast<__nv_bfloat162*>(s_h1 + m * L::LDI + col) =
              __floats2bfloat162_rn(v0, v1);
        }
      }
  }
  __syncthreads();

  for (int i = tid; i < 9 * CIN * (CMID / 8); i += THREADS) {
    const int row = i / (CMID / 8), seg = i - row * (CMID / 8);
    cp_async16(s_w0 + row * L::LDW0 + seg * 8, w0 + (size_t)row * CMID + seg * 8);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // conv2 -> h2 -> 1x1: MT2 m16 tiles of output pixels a warp (rows past
  // the block's pixels repeat its last one: computed, never stored)
  float acc[MT2][NT2][4];
  const bf16* arow[MT2];
#pragma unroll
  for (int mi = 0; mi < MT2; ++mi) {
    const int m = min((warp * MT2 + mi) * 16 + (lane & 15), M2 - 1);
    arow[mi] = s_h1 + ((m / TCOL) * HC + m % TCOL) * L::LDI + (lane >> 4) * 8;
#pragma unroll
    for (int n = 0; n < NT2; ++n) acc[mi][n][0] = acc[mi][n][1] = acc[mi][n][2] = acc[mi][n][3] = 0.f;
  }
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) {
    const int off = ((tap / 3) * HC + tap % 3) * L::LDI;
#pragma unroll
    for (int kc = 0; kc < CIN; kc += 16) {
      uint32_t a[MT2][4];
#pragma unroll
      for (int mi = 0; mi < MT2; ++mi) ldmatrix_x4(a[mi], arow[mi] + off + kc);
#pragma unroll
      for (int np = 0; np < NT2 / 2; ++np) {
        uint32_t b[4];
        load_b_frag_kn(b, s_w0 + (tap * CIN + kc) * L::LDW0 + np * 16, L::LDW0, lane);
#pragma unroll
        for (int mi = 0; mi < MT2; ++mi) {
          mma_bf16(acc[mi][2 * np], a[mi], b[0], b[1]);
          mma_bf16(acc[mi][2 * np + 1], a[mi], b[2], b[3]);
        }
      }
    }
  }

  bf16* ob = out + blockIdx.z * os.b;
#pragma unroll
  for (int mi = 0; mi < MT2; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = (warp * MT2 + mi) * 16 + g + half * 8;
      const int gy = r0 + m / TCOL, gx = c0 + m % TCOL;
      const bool store = m < M2 && gy < h && gx < w;
      float part[MAXO] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int n = 0; n < NT2; ++n) {
        const int col = n * 8 + 2 * t;
        const float h0 = __bfloat162float(
            __float2bfloat16(fmaxf(acc[mi][n][2 * half] + s_b0[col], 0.f)));
        const float h1 = __bfloat162float(
            __float2bfloat16(fmaxf(acc[mi][n][2 * half + 1] + s_b0[col + 1], 0.f)));
#pragma unroll
        for (int o = 0; o < MAXO; ++o)
          part[o] += h0 * s_k1[col * MAXO + o] + h1 * s_k1[(col + 1) * MAXO + o];
      }
#pragma unroll
      for (int o = 0; o < MAXO; ++o) {
        part[o] += __shfl_xor_sync(0xffffffffu, part[o], 1);
        part[o] += __shfl_xor_sync(0xffffffffu, part[o], 2);
      }
      if (t == 0 && store) {
        for (int o = 0; o < nout; ++o)
          ob[gy * os.h + gx * os.w + o * os.c] = __float2bfloat16(part[o] + s_bk[o]);
      }
    }
}

template <int CIN, int CMID>
int launch(const void* x, const void* w1, const void* b1, const void* w0, const void* b0,
           const void* k1, const void* bk, void* out, int batch, int h, int w, int nout,
           Strides xs, Strides os, cudaStream_t st) {
  const size_t bytes = Layout<CIN, CMID>::BYTES;
  const int mode = load_mode(x, w, xs);
  auto kernel = mode == BY_ROW     ? mask_tail_kernel<CIN, CMID, BY_ROW>
                : mode == BY_PIXEL ? mask_tail_kernel<CIN, CMID, BY_PIXEL>
                                   : mask_tail_kernel<CIN, CMID, BY_ELEMENT>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((w + TCOL - 1) / TCOL, (h + TRW - 1) / TRW, batch);
  kernel<<<grid, THREADS, bytes, st>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w1), static_cast<const bf16*>(b1),
      static_cast<const bf16*>(w0), static_cast<const bf16*>(b0), static_cast<const bf16*>(k1),
      static_cast<const bf16*>(bk), static_cast<bf16*>(out), h, w, nout, xs, os);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (batch, h, w, c_in), out: (batch, h, w, n_out), both through strides
// (b, h, w, c); w1: (3, 3, c_in, c_in), w0: (3, 3, c_in, c_mid), k1:
// (c_mid, n_out), all contiguous bf16. (c_in, c_mid) is (64, 96), the
// mask head of every ViT config but the tiny test ones; n_out is 1..4.
extern "C" int s3od_mask_tail(const void* x, const void* w1, const void* b1, const void* w0,
                              const void* b0, const void* k1, const void* bk, void* out,
                              int batch, int h, int w, int cin, int cmid, int nout, long long xsb,
                              long long xsh, long long xsw, long long xsc, long long osb,
                              long long osh, long long osw, long long osc, void* stream) {
  if (batch <= 0 || h <= 0 || w <= 0 || nout < 1 || nout > MAXO || (h + TRW - 1) / TRW > 65535 ||
      batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides xs{xsb, xsh, xsw, xsc}, os{osb, osh, osw, osc};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cin == 64 && cmid == 96)
    return launch<64, 96>(x, w1, b1, w0, b0, k1, bk, out, batch, h, w, nout, xs, os, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
