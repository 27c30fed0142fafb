// K2: single-pass attention forward, softmax(q k^T * scale) v.
//
// Replaces: transmf_ad_tpu/ops/flash_attention.py::_attention_kernel
// (pallas_call at flash_attention.py:78). The TPU kernel holds one query
// block and the whole K/V of a (batch, head) in VMEM, pads keys to a multiple
// of 8 and masks the padding to -1e30 before one softmax pass.
//
// Bound on the card: at the model's shape (B*H = 32, 150 tokens, head 32) the
// whole problem is 2.9 MFLOP and 1.2 MB, so launch latency bounds it. At the
// full-resolution grid (1,573 tokens, 2.5 GFLOP on 1.6 MB a call) it is the
// operations, which for bfloat16 inputs belong on the tensor cores.
//
// Two variants, chosen by the caller from the dtype and the head dim alone
// (ops/flash_attention.py::attention_variant) and refused here when they do
// not fit, each the forward of K10 with the logsumexp store compiled out:
//
// "mma" (bfloat16, D = 16, 32, 64 or 128): FlashAttention-2 tiling on
// mma.sync.m16n8k16, P as hi + lo bfloat16 fragments (attention_mma.cuh,
// where the design is described).
//
// "rows" (float32, or bfloat16 with another head dim): the resident-row
// forward on the CUDA cores (flash_rows.cuh); float32 arithmetic throughout,
// which the float32 checks against the CPU (1e-4) need.
#include "attention_mma.cuh"
#include "flash_rows.cuh"

// q: (BH, N, D); k, v: (BH, M, D); o: (BH, N, D). Needs 1 <= D <= 128, M >= 1.
// variant 1 ("mma"): bfloat16, D in {16, 32, 64, 128}, 16-byte aligned
// pointers; variant 0 ("rows"): any dtype and D.
extern "C" int transmf_attention_fwd(const void* q, const void* k,
                                     const void* v, void* o, int BH, int N,
                                     int M, int D, float scale, int dtype,
                                     int variant, void* stream) {
  using namespace transmf;
  if (variant == 0) {
    return launch_flash_fwd<false>(q, k, v, o, nullptr, BH, N, M, D, scale,
                                   dtype, stream);
  }
  if (variant != 1) return static_cast<int>(cudaErrorInvalidValue);
  return launch_attention_mma<false>(q, k, v, o, nullptr, BH, N, M, D, scale,
                                     dtype, stream);
}
