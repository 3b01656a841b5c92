// The f32 form of waveflow_row.cuh's kernel (its own file, so that nvcc builds
// the two forms' templates in parallel).
#include "waveflow_row.cuh"

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
    float* st, int* launches, void* stream) {
  return run<wn::F32>(x_prev, ring, step, cond, start_w, start_b, k_all, rs_w,
                      rs_b, end_w, end_b, B, C, W, L, kh, kw, plan, scratch, st,
                      launches, stream);
}
