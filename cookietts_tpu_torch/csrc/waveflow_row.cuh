// One height row of the WaveFlow inverse: the 2-D WaveNet coupling net
// (WN2D) evaluated for the row below the rows generated so far,
//   h = start(x_prev); for each of L layers {acts = conv_{kh rows x kw taps,
//   width dilation 2^i}(the layer's last kh-1 input rows, h) + cond_bc[i];
//   out = tanh(acts_a) * sigmoid(acts_g); (res, skip) = res_skip(out);
//   h += res; skip_sum += skip}; (log_s, t) = end(skip_sum)
// and every layer's queue of input rows advanced by one row. Every product
// is computed in the kernels of wn_layer.cuh.
//
// Replaces the TPU kernel cookietts_tpu/ops/pallas_kernels.py:
// waveflow_row_step (body _waveflow_row_kernel), which keeps all L layers
// resident per width tile, pads the width with a 256-column halo, and
// updates the queues in place behind a deferred-write pipeline that relies
// on grid programs running one after another. Blocks of a CUDA grid run
// together, so here the queues are a ring of kh row slots per layer,
// ring [L][kh][B][C][W]: row `step` of a layer's input lives in slot
// step % kh. A layer is two launches (2L + 2 per row): the conv reads all
// kh slots of layer i's ring, with its kernel rows rotated by step % kh,
// into z; the res/skip launch writes h + res into slot step % kh of layer
// i+1's ring: the oldest row there, which no block of either launch reads.
// Nothing is shifted or copied, no block reads what another block of the
// same launch writes, and the width is masked by index, not padded.
//
// Bound on the H100: operations. A layer does 2 * 2C * (kh * kw + 1) * C
// flops per sample (164 kFLOP at C = 64, kh = kw = 3) against 4 * 2C bytes
// of cond and 4 * (kh + 3) * C bytes of rows and skip, about 80 flops per
// byte: above the card's balance on the tensor cores in 3xTF32 (49), so the
// 3xTF32 rate bounds it.
//
// The bf16 form (waveflow_row_step_bf16; wn_layer.cuh's FlowBf16) is JAX's
// kernel with bf16 queues: the ring, z, the weights, cond_bc and the start
// bias bf16, x_prev and the skip sum f32; one bf16 product a term on the
// tensor cores (mma.sync.m16n8k16, f32 accumulators), rounded to bf16
// where JAX's body rounds. A layer moves 2 * 2C bytes of cond, 2 * (kh + 1)
// * C of rows and 8C of the f32 skip sum per sample, about 130 flops per
// byte at C = 64, under the balance of the bf16 rate (989 TFLOP/s for 3.35
// TB/s, 295): bytes bound it. A first, simple form: the A and B fragments
// are packed from 2-byte shared-memory loads.
#pragma once
#include "wn_layer.cuh"

namespace {

// One row step in form Form (wn_layer.cuh). scratch [2][B][C][W] f32: the
// skip sum, then z (in Form::A, at the start of its slot).
template <class Form>
int run(const float* x_prev, typename Form::A* ring, int step,
        const typename Form::W* cond, const typename Form::W* start_w,
        const typename Form::SB* start_b, const typename Form::W* k_all,
        const typename Form::W* rs_w, const float* rs_b,
        const typename Form::W* end_w, const float* end_b, int B, int C, int W,
        int L, int kh, int kw, const int* plan, float* scratch, float* st,
        int* launches, void* stream_) {
  using A = typename Form::A;
  cudaStream_t stream = (cudaStream_t)stream_;
  const wn::Plan p{plan[0], plan[1], plan[2], plan[3], plan[4], plan[5]};
  const size_t slot = (size_t)B * C * W, layer = kh * slot, c2 = 2 * (size_t)C;
  float* skip = scratch;
  A* z = reinterpret_cast<A*>(scratch + slot);
  const int rot = step % kh;
  *launches = 0;
  cudaError_t err = wn::launch_start<Form>(x_prev, start_w, start_b, B, 1, C, W,
                                           ring + rot * slot, stream);
  if (err == cudaSuccess) ++*launches;
  for (int i = 0; i < L && err == cudaSuccess; ++i)
    err = wn::launch_wn_layer<Form>(
        p, i, L, ring + i * layer, slot, kh, rot, cond + i * c2 * W, L * c2 * W,
        k_all + (size_t)i * kh * kw * C * c2, rs_w + i * C * c2, rs_b + i * c2, B,
        C, W, kw, z, i < L - 1 ? ring + (i + 1) * layer + rot * slot : nullptr,
        skip, launches, stream);
  if (err == cudaSuccess) {
    err = wn::launch_end<Form>(skip, end_w, end_b, B, C, 2, W, st, stream);
    if (err == cudaSuccess) ++*launches;
  }
  return (int)err;
}

}  // namespace
