// The bf16 form of waveflow_row.cuh's kernel (its own file, so that nvcc builds
// the two forms' templates in parallel).
#include "waveflow_row.cuh"

// The bf16 form: as waveflow_row_step with ring, cond, start_w, start_b,
// k_all, rs_w and end_w bf16; x_prev, rs_b, end_b, scratch and st f32;
// plan from wn_layer_plan(..., form="flow_bf16").
extern "C" int waveflow_row_step_bf16(
    const float* x_prev, __nv_bfloat16* ring, int step, const __nv_bfloat16* cond,
    const __nv_bfloat16* start_w, const __nv_bfloat16* start_b,
    const __nv_bfloat16* k_all, const __nv_bfloat16* rs_w, const float* rs_b,
    const __nv_bfloat16* end_w, const float* end_b, int B, int C, int W, int L,
    int kh, int kw, const int* plan, float* scratch, float* st, int* launches,
    void* stream) {
  return run<wn::FlowBf16>(x_prev, ring, step, cond, start_w, start_b, k_all, rs_w,
                           rs_b, end_w, end_b, B, C, W, L, kh, kw, plan, scratch,
                           st, launches, stream);
}
