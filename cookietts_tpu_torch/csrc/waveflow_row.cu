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
#include "wn_layer.cuh"

// x_prev [B][W]; ring [L][kh][B][C][W]; cond [B][L][2C][W]; start_w [C];
// k_all [L][kh*kw*C][2C]; rs_w [L][C][2C]; rs_b [L][2C]; end_w [C][2];
// plan: 6 ints (wn::Plan, from wn_layer_plan); scratch [2][B][C][W] (the
// skip sum, z); st [B][2][W] = (log_s, t). Counts the kernels launched in
// *launches. Returns a CUDA error code.
extern "C" int waveflow_row_step(
    const float* x_prev, float* ring, int step, const float* cond,
    const float* start_w, const float* start_b, const float* k_all,
    const float* rs_w, const float* rs_b, const float* end_w, const float* end_b,
    int B, int C, int W, int L, int kh, int kw, const int* plan, float* scratch,
    float* st, int* launches, void* stream_) {
  cudaStream_t stream = (cudaStream_t)stream_;
  const wn::Plan p{plan[0], plan[1], plan[2], plan[3], plan[4], plan[5]};
  const size_t slot = (size_t)B * C * W, layer = kh * slot, c2 = 2 * (size_t)C;
  float *skip = scratch, *z = scratch + slot;
  const int rot = step % kh;
  *launches = 0;
  cudaError_t err = wn::launch_start(x_prev, start_w, start_b, B, 1, C, W,
                                     ring + rot * slot, stream);
  if (err == cudaSuccess) ++*launches;
  for (int i = 0; i < L && err == cudaSuccess; ++i)
    err = wn::launch_wn_layer(
        p, i, L, ring + i * layer, slot, kh, rot, cond + i * c2 * W, L * c2 * W,
        k_all + (size_t)i * kh * kw * C * c2, rs_w + i * C * c2, rs_b + i * c2, B,
        C, W, kw, z, i < L - 1 ? ring + (i + 1) * layer + rot * slot : nullptr,
        skip, launches, stream);
  if (err == cudaSuccess) {
    err = wn::launch_end(skip, end_w, end_b, B, C, 2, W, st, stream);
    if (err == cudaSuccess) ++*launches;
  }
  return (int)err;
}
