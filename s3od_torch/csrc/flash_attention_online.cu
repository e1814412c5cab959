// K7: attention forward with the exact row-max (online) softmax.
//
// Replaces `_fwd_kernel` of `s3od_tpu/ops/flash_attention.py` (the
// streaming online-softmax forward, dispatched by `_flash_forward` and the
// public `flash_attention` without the static bound), and the row-max mode
// of `_fwd_kernel_single` (`static_bound=False`): both compute the same
// exact softmax, and which one the TPU runs is a VMEM rule (`_pick_blocks`)
// that is not ported. The MMDiT reaches it at every attention: 4608 tokens
// at 1024^2 (24 heads of D = 128), 4098 -> 4160 on the concept stream.
//
// Semantics, kept to the letter:
//   - the softmax scale is already folded into q (in bf16) by the caller,
//     so s = q @ k^T;
//   - keys at or past n_valid get the bias -1e30;
//   - m starts at -1e30; m_new = max(m_prev, max_j s_j);
//   - p = exp(s - m_new) is rounded to bf16 for P V, while l sums the fp32 p;
//   - acc and l are rescaled by alpha = exp(m_prev - m_new);
//   - o = acc / l, lse = m + log l (fp32, for a later backward).
// Both exponentials are taken in base 2 with log2(e) folded in:
// p = exp2(fma(s, log2 e, -m log2 e)), a few fp32 ulps from exp(s - m),
// far below the one bf16 rounding of p.
//
// Bound on the H100: 4 * BH * N^2 * D operations (two products), at
// (24, 4608, 128) 2.61e11, 0.264 ms at 989 TFLOP/s, against ~0.11 GB of
// q, k, v, o (0.03 ms at 3.35 TB/s): compute-bound on the tensor cores,
// with one exponential per logit on the SFU as the second limit.
//
// Design (FlashAttention-3's shape, arXiv 2407.08608): the warp-specialised
// kernel of `flash_fwd_ws.cuh` with the online softmax (STATIC = false),
// shared with K3/K6's static bound. A block owns 128 query rows of one
// head; a producer warpgroup loads Q once and 128-key K and V tiles by TMA
// (3-D maps, rows past N load as zeros), and two consumer warpgroups of 64
// rows each issue S = Q K^T by SS wgmma and O += P V by RS wgmma in turns
// (named barriers), so one's softmax runs under the other's products.
// Measured on the H100: the turns were faster than none at D = 64 and no
// slower at D = 128; waiting for S_j alone (wait_group 1) and running the
// softmax under P_{j-1} V_{j-1} measured no faster; with the first key
// tile inside the loop, ptxas serialised the wgmmas (C7514) and the kernel
// ran markedly slower.
//   - Tiles wholly at or past n_valid are skipped: there p = exp(-1e30 -
//     m) = 0 and alpha = 1 exactly, so the result is the full loop's. The
//     key mask runs on the last tile only. Query rows at or past N are
//     computed on zeros and not stored.
#include "flash_fwd_ws.cuh"

// q, k, v, o: (bh, n, d) bf16, 16-byte aligned; lse: (bh, n) fp32. n a
// multiple of 64, d in {64, 128}, 0 < n_valid <= n (checked by the Python
// wrapper).
extern "C" int s3od_flash_attention_online_fwd(const void* q, const void* k, const void* v,
                                               void* o, void* lse, int bh, int n, int d,
                                               int n_valid, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0 || n_valid <= 0 || n_valid > n) return static_cast<int>(cudaErrorInvalidValue);
  if (d == 128) return s3od::flash_ws::launch_fwd<128, false, 2>(q, k, v, o, lse, bh, n, n_valid, st);
  if (d == 64) return s3od::flash_ws::launch_fwd<64, false, 2>(q, k, v, o, lse, bh, n, n_valid, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
