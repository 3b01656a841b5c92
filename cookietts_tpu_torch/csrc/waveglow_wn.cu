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
// the 227 KB of shared memory a block may use, so here one launch is one
// layer (L + 2 launches per call with the start and end products): a layer's
// halo is only (kw//2) * 2^i columns and is read straight from the previous
// layer's h in device memory. h ping-pongs between two buffers, so no block
// overwrites a column that another block still reads as its halo. Within a
// layer the conv output and the gated tile never leave the SM; between
// layers h and the skip sum go through device memory once.
//
// Bound on the H100: operations. A layer does 2 * 2C * (kw + 1) * C flops
// per sample (1.05 MFLOP at C = 256, kw = 3) against 4 * 2C bytes of cond
// read and 4 * 4C bytes of h and skip in and out, about 170 flops per byte:
// above the card's f32 balance of 20, so the f32 rate bounds it.
#include "wn_layer.cuh"

// x [B][Cin][T]; cond [B][L][2C][T]; start_w [Cin][C]; k_all [L][kw*C][2C];
// rs_w [L][C][2C]; rs_b [L][2C]; end_w [C][Cout]; scratch [3][B][C][T] (two h
// buffers and the skip sum); st [B][Cout][T]. Returns a CUDA error code.
extern "C" int waveglow_wn_forward(
    const float* x, const float* cond, const float* start_w, const float* start_b,
    const float* k_all, const float* rs_w, const float* rs_b, const float* end_w,
    const float* end_b, int B, int Cin, int C, int Cout, int T, int L, int kw,
    float* scratch, float* st, void* stream_) {
  cudaStream_t stream = (cudaStream_t)stream_;
  const size_t bct = (size_t)B * C * T, c2 = 2 * (size_t)C;
  float* h[2] = {scratch, scratch + bct};
  float* skip = scratch + 2 * bct;
  const int kt = wn::wn_pick_kt(B, C, T);
  cudaError_t err = wn::launch_start(x, start_w, start_b, B, Cin, C, T, h[0], stream);
  for (int i = 0; i < L && err == cudaSuccess; ++i)
    err = wn::launch_layer(kt, i < L - 1, h[i % 2], 0, 1, 0, cond + i * c2 * T,
                           L * c2 * T, k_all + i * kw * C * c2, rs_w + i * C * c2,
                           rs_b + i * c2, B, C, T, kw, 1 << i, i == 0,
                           h[(i + 1) % 2], skip, stream);
  if (err == cudaSuccess)
    err = wn::launch_end(skip, end_w, end_b, B, C, Cout, T, st, stream);
  return (int)err;
}

// Samples per thread of the layer kernel: 0 lets every launch pick (the
// default), 4, 5 or 8 forces one tile width, for tools/bench_wn_tiles.py.
extern "C" void waveglow_wn_force_kt(int kt) { wn::wn_forced_kt() = kt; }
