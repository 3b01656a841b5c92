// The whole WaveNet coupling net (WN) of one WaveGlow flow:
//   h = start(x); for each of L layers {acts = conv_{kw taps, dilation 2^i}(h)
//   + cond_bc[i]; out = tanh(acts_a) * sigmoid(acts_g); (res, skip) =
//   res_skip(out); h += res; skip_sum += skip}; st = end(skip_sum)
// with zero padding at both ends of the sequence. Every product (start, the
// per-layer conv, res/skip, end) is computed in the kernels of wn_layer.cuh.
//
// Replaces the TPU kernel cookietts_tpu/ops/pallas_kernels.py:
// waveglow_wn_forward (body _waveglow_wn_kernel), which keeps all L layers
// resident per width tile with a halo of (kw//2) * (2^L - 1) columns on each
// side. At C = 256 in f32 one [C, tile + 2 * 255] buffer alone is more than
// the 227 KB of shared memory a block may use, so here a layer is two
// launches (the conv into z, then res/skip; 2L + 2 launches per call with
// the start and end products): a layer's halo is only (kw//2) * 2^i columns
// and is read straight from h in device memory. The conv reads h and writes
// z; the res/skip launch updates h in place (each element by the thread
// that reads it), so one h buffer serves every layer.
//
// Bound on the H100: operations. A layer does 2 * 2C * (kw + 1) * C flops
// per sample (1.05 MFLOP at C = 256, kw = 3) against 4 * 2C bytes of cond
// read and 4 * 4C bytes of h and skip in and out, about 170 flops per byte:
// above the card's balance even on the tensor cores in 3xTF32 (165 TFLOP/s
// for 3.35 TB/s, 49), so the 3xTF32 rate bounds it.
#include "wn_layer.cuh"

// x [B][Cin][T]; cond [B][L][2C][T]; start_w [Cin][C]; k_all [L][kw*C][2C];
// rs_w [L][C][2C]; rs_b [L][2C]; end_w [C][Cout]; plan: 6 ints (wn::Plan,
// from wn_layer_plan); scratch [3][B][C][T] (h, the skip sum, z);
// st [B][Cout][T]. Counts the kernels launched in *launches. Returns a CUDA
// error code.
extern "C" int waveglow_wn_forward(
    const float* x, const float* cond, const float* start_w, const float* start_b,
    const float* k_all, const float* rs_w, const float* rs_b, const float* end_w,
    const float* end_b, int B, int Cin, int C, int Cout, int T, int L, int kw,
    const int* plan, float* scratch, float* st, int* launches, void* stream_) {
  cudaStream_t stream = (cudaStream_t)stream_;
  const wn::Plan p{plan[0], plan[1], plan[2], plan[3], plan[4], plan[5]};
  const size_t bct = (size_t)B * C * T, c2 = 2 * (size_t)C;
  float *h = scratch, *skip = scratch + bct, *z = scratch + 2 * bct;
  *launches = 0;
  cudaError_t err = wn::launch_start(x, start_w, start_b, B, Cin, C, T, h, stream);
  if (err == cudaSuccess) ++*launches;
  for (int i = 0; i < L && err == cudaSuccess; ++i)
    err = wn::launch_wn_layer(p, i, L, h, 0, 1, 0, cond + i * c2 * T, L * c2 * T,
                              k_all + i * kw * C * c2, rs_w + i * C * c2,
                              rs_b + i * c2, B, C, T, kw, z, h, skip, launches,
                              stream);
  if (err == cudaSuccess) {
    err = wn::launch_end(skip, end_w, end_b, B, C, Cout, T, st, stream);
    if (err == cudaSuccess) ++*launches;
  }
  return (int)err;
}
