// E3b: the exponential throughput loop of the exp-against-exp2 experiment.
//
// Replaces the TPU kernel `make_loop` -> `kern` of `benchmarks/exp_exp2.py`
// (section A): a grid of P programs, each applying f sixteen times to a
// resident (B, B) fp32 block and writing it to output block i mod 8, so
// out[r, c] = f^R(x[r mod B, c]) for out (8B, B). Five f, as in the script:
//   0 mul        a * 1.0000001
//   1 exp        expf(a)
//   2 exp2       exp2f(a)
//   3 clip+sub+exp         expf(clip(a, -40, 40) - 40)
//   4 fma+clip+sub+exp2    exp2f(clip(a * log2 e + 0, -57.7, 57.7) - 57.7)
// exp and exp2 of [-40, 0] overflow to +inf after five iterations; the
// kernel keeps them as inf, as the TPU does.
//
// The experiment is about which instructions the exponential becomes, so it
// is CUDA, built without fast math: `expf` and `exp2f` are the accurate
// library functions (exp2f is the SFU's ex2 alone; expf adds a range
// reduction in FMAs in front of it), and every program does its full share
// of the work, as each TPU program did: P B^2 R evaluations of f, 1.07e9 at
// the default (256, 512, 16). A block of 256 threads takes 1024 elements of
// one program's block, four independent chains a thread.
//
// Bound on the H100: the function itself needs 9.4 MB of traffic (x read,
// out written once) and B^2 R evaluations, 2.8 us; the experiment's
// redundant work, 1.07e9 exponentials at the SFUs' ~3.9e12/s, ~0.28 ms,
// is what it measures.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256, PER_THREAD = 4, CHUNK = THREADS * PER_THREAD;
constexpr float LOG2E = 1.4426950408889634f;

template <int F>
__device__ __forceinline__ float step(float a) {
  if (F == 0) return a * 1.0000001f;
  if (F == 1) return expf(a);
  if (F == 2) return exp2f(a);
  if (F == 3) return expf(fminf(fmaxf(a, -40.f), 40.f) - 40.f);
  return exp2f(fminf(fmaxf(a * LOG2E + 0.f, -57.7f), 57.7f) - 57.7f);
}

template <int F>
__global__ void __launch_bounds__(THREADS)
    exp_loop_kernel(const float* __restrict__ x, float* __restrict__ out, int elems,
                    int chunks, int reps) {
  const int prog = blockIdx.x / chunks;
  const int e0 = (blockIdx.x % chunks) * CHUNK + threadIdx.x;
  float a[PER_THREAD];
#pragma unroll
  for (int i = 0; i < PER_THREAD; ++i) {
    const int e = e0 + i * THREADS;
    a[i] = e < elems ? x[e] : 0.f;
  }
  for (int r = 0; r < reps; ++r) {
#pragma unroll
    for (int i = 0; i < PER_THREAD; ++i) a[i] = step<F>(a[i]);
  }
  float* ob = out + (size_t)(prog % 8) * elems;
#pragma unroll
  for (int i = 0; i < PER_THREAD; ++i) {
    const int e = e0 + i * THREADS;
    if (e < elems) ob[e] = a[i];
  }
}

template <int F>
int launch(const float* x, float* out, int elems, int programs, int reps, cudaStream_t st) {
  const int chunks = (elems + CHUNK - 1) / CHUNK;
  exp_loop_kernel<F><<<programs * chunks, THREADS, 0, st>>>(x, out, elems, chunks, reps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (B, B) fp32, elems = B * B; out: (8B, B) fp32. programs >= 8, variant
// in 0..4 (checked by the Python wrapper).
extern "C" int s3od_exp_loop(const void* x, void* out, int elems, int programs, int reps,
                             int variant, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xx = static_cast<const float*>(x);
  float* oo = static_cast<float*>(out);
  switch (variant) {
    case 0: return launch<0>(xx, oo, elems, programs, reps, st);
    case 1: return launch<1>(xx, oo, elems, programs, reps, st);
    case 2: return launch<2>(xx, oo, elems, programs, reps, st);
    case 3: return launch<3>(xx, oo, elems, programs, reps, st);
    case 4: return launch<4>(xx, oo, elems, programs, reps, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
