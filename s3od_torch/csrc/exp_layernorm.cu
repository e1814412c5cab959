// E2: the single-pass LayerNorm of the LayerNorm-statistics experiment.
//
// Replaces the TPU kernel `benchmarks/exp_layernorm.py:_ln_kernel` (via
// `pallas_ln`). Per row of x (rows, C) bf16: fp32 m1 = E[x] and m2 =
// E[x^2], var = m2 - m1^2 with NO clamp at 0 (unlike K1 and K4), rstd =
// rsqrt(var + eps), y = ((x - m1) rstd) w + b with fp32 w and b, rounded
// to bf16 once.
//
// Bound on the H100: no products; each row is read once and written once,
// 2 x 2 x C bytes (8 x 4104 x 768 at the script's default: 101 MB, 0.030
// ms at 3.35 TB/s). All a kernel can do is keep enough bytes in flight,
// in full 16-byte accesses: a producer warp keeps a ring of
// `cp.async.bulk` copies of 8 consecutive rows (2-4 stages, ~96 KB) in
// shared memory on mbarriers, a few blocks an SM, and 8 consumer warps
// each finish one row of a stage: the lane's ceil(C / 256) 16-byte vectors
// of the row (3 at C = 768, no lane idle), w and b of its columns held in
// registers across rows up to C = 1024, both sums by `__shfl_xor_sync`,
// 16-byte stores. It reads ~2.6 TB/s on the H100, 3% faster than one warp
// a row loading straight into registers and than the Triton kernel it
// replaces (PERF.md section 6): the bytes bound it, not the form.
// C is a multiple of 8 up to 4096; anything else is refused.
#include "hopper.cuh"  // and mma.cuh

using namespace s3od;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int LB_WARPS = 8;  // consumer warps: rows a stage
constexpr int LB_THREADS = 32 * (LB_WARPS + 1);
constexpr int LB_RING_BYTES = 98304;  // the ring's target size: 2 to 4 stages

__device__ __forceinline__ void unpack8(const uint4& v, float (&f)[8]) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 q = __bfloat1622float2(p[i]);
    f[2 * i] = q.x;
    f[2 * i + 1] = q.y;
  }
}

// The 8 fp32 values at 8 i of a (C,) vector.
__device__ __forceinline__ void load8(const float* __restrict__ g, int i, float (&v)[8]) {
  const float4 a = reinterpret_cast<const float4*>(g + 8 * i)[0];
  const float4 b = reinterpret_cast<const float4*>(g + 8 * i)[1];
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}

template <int V>  // 16-byte vectors a lane: ceil(C / 256)
__global__ void __launch_bounds__(LB_THREADS)
    ln_bulk_kernel(const bf16* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ b, bf16* __restrict__ y, int rows, int c, float eps,
                   int stages) {
  using namespace s3od::hopper;
  constexpr bool HELD = V <= 4;  // w and b in registers; else re-read from L1
  extern __shared__ __align__(128) unsigned char smem[];
  const int row_bytes = 2 * c;
  bf16* ring = reinterpret_cast<bf16*>(smem);  // [stages][LB_WARPS][c]
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + (size_t)stages * LB_WARPS * row_bytes);
  uint64_t* empty = full + stages;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int groups = (rows + LB_WARPS - 1) / LB_WARPS;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], LB_WARPS);
    }
    fence_barrier_init();
  }
  __syncthreads();
  if (warp == LB_WARPS) {  // the producer
    if (lane == 0) {
      int s = 0, ph = 0;
      for (int gi = blockIdx.x; gi < groups; gi += gridDim.x) {
        const int nr = min(LB_WARPS, rows - gi * LB_WARPS);
        mbar_wait(&empty[s], ph ^ 1);
        mbar_expect_tx(&full[s], nr * row_bytes);
        bulk_load(ring + (size_t)s * LB_WARPS * c, x + (size_t)gi * LB_WARPS * c,
                  nr * row_bytes, &full[s]);
        if (++s == stages) {
          s = 0;
          ph ^= 1;
        }
      }
    }
    return;
  }
  const int cv = c >> 3;  // 16-byte vectors a row
  float wh[HELD ? V : 1][8], bh[HELD ? V : 1][8];
  if constexpr (HELD) {
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int i = v * 32 + lane;
#pragma unroll
      for (int e = 0; e < 8; ++e) wh[v][e] = bh[v][e] = 0.f;
      if (i < cv) {
        load8(w, i, wh[v]);
        load8(b, i, bh[v]);
      }
    }
  }
  int s = 0, ph = 0;
  for (int gi = blockIdx.x; gi < groups; gi += gridDim.x) {
    const int row = gi * LB_WARPS + warp;
    mbar_wait(&full[s], ph);
    if (row < rows) {
      const bf16* xs = ring + ((size_t)s * LB_WARPS + warp) * c;
      uint4 xv[V];  // masked lanes hold zeros
      float s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const int i = v * 32 + lane;
        xv[v] = i < cv ? *reinterpret_cast<const uint4*>(xs + 8 * i) : make_uint4(0, 0, 0, 0);
        float f[8];
        unpack8(xv[v], f);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          s1 += f[e];
          s2 += f[e] * f[e];
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        s1 += __shfl_xor_sync(0xffffffff, s1, off);
        s2 += __shfl_xor_sync(0xffffffff, s2, off);
      }
      const float m1 = s1 / c;
      const float rstd = rsqrtf(s2 / c - m1 * m1 + eps);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const int i = v * 32 + lane;
        if (i < cv) {
          float wv[8], bv[8];
          if constexpr (HELD) {
#pragma unroll
            for (int e = 0; e < 8; ++e) wv[e] = wh[v][e], bv[e] = bh[v][e];
          } else {
            load8(w, i, wv);
            load8(b, i, bv);
          }
          float f[8];
          unpack8(xv[v], f);
          uint4 out;
          uint32_t* o = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            o[e] = pack_bf16((f[2 * e] - m1) * rstd * wv[2 * e] + bv[2 * e],
                             (f[2 * e + 1] - m1) * rstd * wv[2 * e + 1] + bv[2 * e + 1]);
          *reinterpret_cast<uint4*>(y + (size_t)row * c + 8 * i) = out;
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
    if (++s == stages) {
      s = 0;
      ph ^= 1;
    }
  }
}

// mirrored by `s3od_torch/experiments/exp_layernorm.py:plan`
template <int V>
int launch_ln(const void* x, const void* w, const void* b, void* y, int rows, int c, float eps,
              cudaStream_t st) {
  auto kernel = ln_bulk_kernel<V>;
  const int stage_bytes = LB_WARPS * 2 * c;
  int stages = LB_RING_BYTES / stage_bytes;
  stages = stages < 2 ? 2 : (stages > 4 ? 4 : stages);
  const int smem = stages * stage_bytes + 2 * stages * 8;
  // the shared-memory opt-in and the resident blocks an SM, once per width
  static int last_c = 0, per_sm = 0;
  if (c != last_c) {
    cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, LB_THREADS, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (per_sm <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
    last_c = c;
  }
  const long long need = (rows + LB_WARPS - 1) / LB_WARPS;
  const long long most = (long long)per_sm * s3od::hopper::sm_count();
  kernel<<<(int)(need < most ? need : most), LB_THREADS, smem, st>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(w), static_cast<const float*>(b),
      static_cast<bf16*>(y), rows, c, eps, stages);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// x, y: (rows, c) bf16; w, b: (c,) fp32; all contiguous and 16-byte
// aligned; c a multiple of 8 up to 4096. Anything else is refused.
extern "C" int s3od_ln_single_pass(const void* x, const void* w, const void* b, void* y,
                                   int rows, int c, float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || c <= 0 || c % 8 || c > 4096) return static_cast<int>(cudaErrorInvalidValue);
  const void* ptrs[4] = {x, w, b, y};
  for (const void* p : ptrs)
    if (!aligned16(p)) return static_cast<int>(cudaErrorInvalidValue);
  typedef int (*Launch)(const void*, const void*, const void*, void*, int, int, float,
                        cudaStream_t);
  static const Launch table[16] = {
      launch_ln<1>,  launch_ln<2>,  launch_ln<3>,  launch_ln<4>,  launch_ln<5>,  launch_ln<6>,
      launch_ln<7>,  launch_ln<8>,  launch_ln<9>,  launch_ln<10>, launch_ln<11>, launch_ln<12>,
      launch_ln<13>, launch_ln<14>, launch_ln<15>, launch_ln<16>};
  return table[(c + 255) / 256 - 1](x, w, b, y, rows, c, eps, st);
}
