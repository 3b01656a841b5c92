// The bf16 form of waveglow_wn.cuh's kernel (its own file, so that nvcc builds
// the two forms' templates in parallel).
#include "waveglow_wn.cuh"

// The bf16 form: as waveglow_wn_forward with cond, start_w, k_all, rs_w
// and end_w bf16; x, the biases, scratch and st f32; plan from
// wn_layer_plan(..., form="glow_bf16").
extern "C" int waveglow_wn_forward_bf16(
    const float* x, const __nv_bfloat16* cond, const __nv_bfloat16* start_w,
    const float* start_b, const __nv_bfloat16* k_all, const __nv_bfloat16* rs_w,
    const float* rs_b, const __nv_bfloat16* end_w, const float* end_b, int B,
    int Cin, int C, int Cout, int T, int L, int kw, const int* plan,
    float* scratch, float* st, int* launches, void* stream) {
  return run<wn::GlowBf16>(x, cond, start_w, start_b, k_all, rs_w, rs_b, end_w,
                           end_b, B, Cin, C, Cout, T, L, kw, plan, scratch, st,
                           launches, stream);
}
