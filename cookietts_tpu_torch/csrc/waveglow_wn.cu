// The f32 form of waveglow_wn.cuh's kernel (its own file, so that nvcc builds
// the two forms' templates in parallel).
#include "waveglow_wn.cuh"

// x [B][Cin][T]; cond [B][L][2C][T]; start_w [Cin][C]; k_all [L][kw*C][2C];
// rs_w [L][C][2C]; rs_b [L][2C]; end_w [C][Cout]; plan: 6 ints (wn::Plan,
// from wn_layer_plan); scratch [3][B][C][T] (h, the skip sum, z);
// st [B][Cout][T]. Counts the kernels launched in *launches. Returns a CUDA
// error code.
extern "C" int waveglow_wn_forward(
    const float* x, const float* cond, const float* start_w, const float* start_b,
    const float* k_all, const float* rs_w, const float* rs_b, const float* end_w,
    const float* end_b, int B, int Cin, int C, int Cout, int T, int L, int kw,
    const int* plan, float* scratch, float* st, int* launches, void* stream) {
  return run<wn::F32>(x, cond, start_w, start_b, k_all, rs_w, rs_b, end_w, end_b,
                      B, Cin, C, Cout, T, L, kw, plan, scratch, st, launches,
                      stream);
}
