// Fused last-layer gradient pieces for classification heads, for Hopper.
//
// Replaces the Pallas TPU kernel src/repro/kernels/lastlayer_grad.py:
// lastlayer_grad:
//   resid = softmax(Z) - onehot(Y)        (n, C)
//   hgrad = resid[i, y_i] * hidden_i      (n, d_h)
//
// What bounds it on an H100: a few flops and one exp per logit, so device
// memory bounds it: it reads hidden, Z and the labels once and writes resid
// and hgrad once.  The design gives one warp to a row: the row max, the exp
// sum and the own-class term stay in registers, each row is read with
// neighbouring lanes on neighbouring addresses, and nothing but the two
// outputs goes back to memory.
#include "common.cuh"

namespace repro_torch {
namespace {

template <typename L>
__global__ void __launch_bounds__(kThreads)
lastlayer_grad_kernel(const float* __restrict__ hidden,
                      const float* __restrict__ logits,
                      const L* __restrict__ labels, float* __restrict__ resid,
                      float* __restrict__ hgrad, int64_t n, int64_t dh,
                      int64_t nc) {
  const int lane = threadIdx.x & 31;
  const int64_t nwarps = static_cast<int64_t>(gridDim.x) * kWarpsPerBlock;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock +
                   (threadIdx.x >> 5);
       i < n; i += nwarps) {
    const float* z = logits + i * nc;
    float m = -INFINITY;
    for (int64_t c = lane; c < nc; c += 32) m = fmaxf(m, z[c]);
    m = warp_max(m);
    float sum = 0.f;
    for (int64_t c = lane; c < nc; c += 32) sum += expf(z[c] - m);
    sum = warp_sum(sum);
    const int64_t y = static_cast<int64_t>(labels[i]);
    float* out = resid + i * nc;
    for (int64_t c = lane; c < nc; c += 32)
      out[c] = expf(z[c] - m) / sum - (c == y ? 1.f : 0.f);
    // The same expression as resid[i, y], so the two outputs agree exactly.
    const float own = (y >= 0 && y < nc) ? expf(z[y] - m) / sum - 1.f : 0.f;
    const float* h = hidden + i * dh;
    float* hg = hgrad + i * dh;
    for (int64_t j = lane; j < dh; j += 32) hg[j] = own * h[j];
  }
}

}  // namespace
}  // namespace repro_torch

using namespace repro_torch;

extern "C" {

// label64: 1 for int64 labels, 0 for int32.  Returns cudaGetLastError().
int rt_lastlayer_grad(int device, const float* hidden, const float* logits,
                      const void* labels, int label64, float* resid,
                      float* hgrad, int64_t n, int64_t dh, int64_t nc,
                      void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t blocks = blocks_for_rows(n);
  if (label64)
    lastlayer_grad_kernel<int64_t><<<blocks, kThreads, 0, s>>>(
        hidden, logits, static_cast<const int64_t*>(labels), resid, hgrad, n,
        dh, nc);
  else
    lastlayer_grad_kernel<int32_t><<<blocks, kThreads, 0, s>>>(
        hidden, logits, static_cast<const int32_t*>(labels), resid, hgrad, n,
        dh, nc);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
