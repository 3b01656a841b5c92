// One step of location-sensitive attention, fused: energies, mask, softmax
// and the context product in one launch.
//
// Replaces the TPU kernel cookietts_tpu/ops/pallas_kernels.py:attention_step
// (body _attention_kernel). Computes, for batch row b:
//   e[t]   = scale * sum_a v[a] * tanh(qp[b,a] + lp[b,t,a] + mp[b,t,a])
//   e[t]   = mask[b,t] ? e[t] : -1e30
//   w[b,:] = softmax(e)
//   ctx[b,d] = sum_t w[b,t] * memory[b,t,d]
// scale is a device scalar (the learned softmax temperature) or null for 1.
//
// Bound on the H100: neither bytes nor operations but latency. The step
// moves a few hundred KB (lp, mp, memory: [B,T,A] twice and [B,T,D]) and
// does O(T*(A+D)) flops, a fraction of a microsecond at the card's rates,
// while a block that walks T rows itself waits on device memory once per
// batch of rows. v2 (one block per batch row) took about 12 dependent round
// trips at T=64 and read every row, though the decoder's window admits at
// most 2 * range + 1 of them and a masked row's weight is exactly 0.
//
// v3: one thread-block cluster of S blocks per batch row (grid S x B),
// split along T; block r owns rows [r R, r R + R). The launch plan (S, R,
// rows a stage holds) comes from attention_step_plan in
// ops/hopper_kernels.py. Each block
//   1. reads its chunk of the mask and lists its admitted rows;
//   2. copies lp, mp and memory of those rows, and of no other, into shared
//      memory with 16-byte cp.async (4-byte copies at a row's ragged ends,
//      so any A and D work), all of a stage's copies in flight at once and
//      waited on once; with more admitted rows than a stage holds, the
//      stages follow each other in the one buffer;
//   3. computes the energies (a warp per row, a across the lanes), keeps a
//      running max m and sum l of exp(e - m), and sums its rows into a
//      partial context [D] rescaled as m grows (online softmax);
//   4. after cluster.sync(), reads every block's (m, l) over distributed
//      shared memory (lane r of warp 0 from block r) and writes w for its
//      rows (0 for masked ones, as exp of -1e30 minus the max is in f32);
//   5. sums its D/S slice of ctx over the S partials in rank order, the S
//      remote reads in flight at once: no atomics, so the bits repeat.
// Pushing the statistics and partials into the blocks that combine them
// (remote stores, one barrier, no remote loads) measured slower at B <= 4
// (tools/bench_attention.py), so the blocks pull.
// A row whose mask is empty keeps its meaning (uniform weights 1/T, ctx
// the mean of memory over all T rows): the cluster sees no admitted row
// anywhere and takes a second pass that reads memory for every row.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kClusterMax = 16;
constexpr int kMisc = 64;          // floats: warp counts and statistics
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Floats of a staged row segment of n values: room for the source's shift
// within 16 bytes (0-3 floats), rounded up to whole 16-byte words.
__host__ __device__ __forceinline__ int seg(int n) { return (n + 6) / 4 * 4; }

// The float offset, mod 4, of a global address: a segment is staged at
// this offset inside its slot, so source and destination agree mod 16 bytes.
__device__ __forceinline__ int shift_of(const float* p) {
  return (int)((reinterpret_cast<uintptr_t>(p) >> 2) & 3);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
}

// One warp copies n floats from src into slot (seg(n) floats):
// 4-byte copies up to src's first 16-byte boundary and after its last,
// 16-byte copies between.
__device__ __forceinline__ void copy_segment(float* slot, const float* src,
                                             int n, int lane) {
  const int sh = shift_of(src);
  float* dst = slot + sh;
  const int head = min(n, (4 - sh) & 3);
  const int body = (n - head) >> 2;
  const int tail = n - head - 4 * body;
  if (lane < head) cp_async4(dst + lane, src + lane);
  for (int k = lane; k < body; k += 32)
    cp_async16(dst + head + 4 * k, src + head + 4 * k);
  if (lane < tail) {
    const int j = head + 4 * body + lane;
    cp_async4(dst + j, src + j);
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

struct Layout {
  int row;        // floats of one staged row: lp, mp, memory segments
  int fixed;      // floats before the staged rows (a whole 16-byte word)
  size_t bytes;   // dynamic shared memory of a block
};

__host__ __device__ inline Layout layout(int A, int D, int R, int stage_rows) {
  Layout l;
  l.row = 2 * seg(A) + seg(D);
  l.fixed = (2 * A + 2 * R + stage_rows + kMisc + D + 3) / 4 * 4;
  l.bytes = sizeof(float) * ((size_t)l.fixed + (size_t)stage_rows * l.row);
  return l;
}

__global__ void __launch_bounds__(kThreads)
attention_step_kernel(const float* __restrict__ qp, const float* __restrict__ lp,
                      const float* __restrict__ mp, const float* __restrict__ v,
                      const float* __restrict__ memory,
                      const unsigned char* __restrict__ mask,
                      const float* __restrict__ scale, int T, int A, int D,
                      int R, int stage_rows, float* __restrict__ ctx,
                      float* __restrict__ w) {
  extern __shared__ __align__(16) float smem[];
  const Layout lay = layout(A, D, R, stage_rows);
  float* q_s = smem;                                   // [A]
  float* v_s = q_s + A;                                // [A]
  float* e_s = v_s + A;                                // [R] energies
  int* idx_s = reinterpret_cast<int*>(e_s + R);        // [R] admitted rows
  float* p_s = reinterpret_cast<float*>(idx_s + R);    // [stage_rows]
  float* misc = p_s + stage_rows;                      // [kMisc]
  float* part_s = misc + kMisc;                        // [D] partial context
  float* buf = smem + lay.fixed;                       // [stage_rows][row]
  int* cnt_s = reinterpret_cast<int*>(misc);           // [kWarps]
  float* stat_s = misc + kWarps;                       // m, l; M, L
  float* corr_s = stat_s + 4;                          // a stage's rescale
  float* fac_s = corr_s + 1;                           // [kClusterMax]

  cg::cluster_group cluster = cg::this_cluster();
  const int S = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t0 = rank * R;
  const int n_rows = max(0, min(R, T - t0));
  const float sc = scale ? __ldg(scale) : 1.f;

  for (int a = tid; a < A; a += kThreads) {
    q_s[a] = __ldg(qp + (size_t)b * A + a);
    v_s[a] = __ldg(v + a);
  }
  for (int d = tid; d < D; d += kThreads) part_s[d] = 0.f;
  for (int j = tid; j < n_rows; j += kThreads) e_s[j] = kNeg;

  // 1. the admitted rows of this block's chunk, in order
  const unsigned char* mask_b = mask + (size_t)b * T + t0;
  int n_adm = 0;
  for (int c0 = 0; c0 < n_rows; c0 += kThreads) {
    const int j = c0 + tid;
    const bool adm = j < n_rows && mask_b[j] != 0;
    const unsigned bal = __ballot_sync(0xffffffffu, adm);
    if (lane == 0) cnt_s[warp] = __popc(bal);
    __syncthreads();
    int off = n_adm, total = 0;
    for (int k = 0; k < kWarps; ++k) {
      off += k < warp ? cnt_s[k] : 0;
      total += cnt_s[k];
    }
    if (adm) idx_s[off + __popc(bal & ((1u << lane) - 1u))] = j;
    n_adm += total;
    __syncthreads();
  }

  // 2. stage the admitted rows' lp, mp and memory; 3. energies, online
  // softmax statistics and the partial context
  const size_t row0 = (size_t)b * T + t0;
  float m_run = -INFINITY, l_run = 0.f;    // meaningful in warp 0
  for (int first = 0; first < n_adm; first += stage_rows) {
    const int n = min(stage_rows, n_adm - first);
    for (int i = warp; i < n; i += kWarps) {
      const size_t t = row0 + idx_s[first + i];
      float* slot = buf + (size_t)i * lay.row;
      copy_segment(slot, lp + t * A, A, lane);
      copy_segment(slot + seg(A), mp + t * A, A, lane);
      copy_segment(slot + 2 * seg(A), memory + t * D, D, lane);
    }
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    for (int i = warp; i < n; i += kWarps) {
      const int j = idx_s[first + i];
      const float* slot = buf + (size_t)i * lay.row;
      const float* l_row = slot + shift_of(lp + (row0 + j) * A);
      const float* m_row = slot + seg(A) + shift_of(mp + (row0 + j) * A);
      float acc = 0.f;
      for (int a = lane; a < A; a += 32)
        acc += v_s[a] * tanhf(q_s[a] + l_row[a] + m_row[a]);
      acc = warp_sum(acc);
      if (lane == 0) e_s[j] = acc * sc;
    }
    __syncthreads();
    if (warp == 0) {
      float m = -INFINITY;
      for (int i = lane; i < n; i += 32) m = fmaxf(m, e_s[idx_s[first + i]]);
      const float m_new = fmaxf(m_run, warp_max(m));
      float l = 0.f;
      for (int i = lane; i < n; i += 32) {
        const float p = expf(e_s[idx_s[first + i]] - m_new);
        p_s[i] = p;
        l += p;
      }
      const float corr = expf(m_run - m_new);     // 0 at the first stage
      l_run = l_run * corr + warp_sum(l);
      m_run = m_new;
      if (lane == 0) *corr_s = corr;
    }
    __syncthreads();
    const float corr = *corr_s;
    for (int d = tid; d < D; d += kThreads) {
      float acc = part_s[d] * corr;
      for (int i = 0; i < n; ++i) {
        const float* mem_row = buf + (size_t)i * lay.row + 2 * seg(A) +
                               shift_of(memory + (row0 + idx_s[first + i]) * D);
        acc += p_s[i] * mem_row[d];
      }
      part_s[d] = acc;
    }
    __syncthreads();    // the buffer is free for the next stage
  }
  if (tid == 0) {
    stat_s[0] = m_run;
    stat_s[1] = l_run;
  }
  cluster.sync();

  // 4. warp 0 reads block r's (m, l) in lane r and forms the cluster's max
  // M and sum L and every block's factor exp(m - M) / L
  if (warp == 0) {
    float m_r = -INFINITY, l_r = 0.f;
    if (lane < S) {
      const float* st = cluster.map_shared_rank(stat_s, lane);
      m_r = st[0];
      l_r = st[1];
    }
    const float M = warp_max(m_r);
    const float f = m_r == -INFINITY ? 0.f : expf(m_r - M);
    const float L = warp_sum(l_r * f);
    if (lane < S) fac_s[lane] = M == -INFINITY ? 1.f / (float)T : f / L;
    if (lane == 0) {
      stat_s[2] = M;
      stat_s[3] = L;
    }
  }
  __syncthreads();
  const float M = stat_s[2], L = stat_s[3];
  const bool empty = M == -INFINITY;        // every energy is -1e30
  if (empty) {
    // uniform weights: ctx is the mean of memory over all T rows
    for (int d = tid; d < D; d += kThreads) {
      float acc = 0.f;
      for (int j = 0; j < n_rows; ++j) acc += __ldg(memory + (row0 + j) * D + d);
      part_s[d] = acc;
    }
    cluster.sync();
  }
  for (int j = tid; j < n_rows; j += kThreads)
    w[row0 + j] = empty ? 1.f / (float)T : expf(e_s[j] - M) / L;
  // 5. this block's D/S slice of ctx: the S partials read over distributed
  // shared memory, all in flight at once, summed in rank order
  const int Dc = (D + S - 1) / S;
  const int d_end = min(D, (rank + 1) * Dc);
  for (int d = rank * Dc + tid; d < d_end; d += kThreads) {
    float part[kClusterMax];
#pragma unroll
    for (int r = 0; r < kClusterMax; ++r)
      part[r] = r < S ? cluster.map_shared_rank(part_s, r)[d] : 0.f;
    float acc = 0.f;
#pragma unroll
    for (int r = 0; r < kClusterMax; ++r)
      if (r < S) acc += fac_s[r] * part[r];
    ctx[(size_t)b * D + d] = acc;
  }
  cluster.sync();     // no block leaves while another reads its partials
}

// The least time a launch of this shape can take: an empty kernel on the
// same grid and cluster (chip_smoke.py and tools/bench_attention.py time it
// as the floor beside the bound; the port does not call it).
__global__ void empty_kernel(int) {}

int max_smem_set = 48 * 1024;
bool non_portable_set = false;
bool empty_non_portable_set = false;

}  // namespace

extern "C" int attention_step_smem(int A, int D, int R, int stage_rows) {
  return (int)layout(A, D, R, stage_rows).bytes;
}

extern "C" int attention_step(const float* qp, const float* lp, const float* mp,
                              const float* v, const float* memory,
                              const unsigned char* mask, const float* scale,
                              int B, int T, int A, int D, int S, int R,
                              int stage_rows, float* ctx, float* w,
                              void* stream) {
  if (S < 1 || S > kClusterMax || R < 1 || (long long)S * R < T ||
      stage_rows < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = layout(A, D, R, stage_rows).bytes;
  if ((int)smem > max_smem_set) {
    cudaError_t err = cudaFuncSetAttribute(
        attention_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    max_smem_set = (int)smem;
  }
  if (S > 8 && !non_portable_set) {
    cudaError_t err = cudaFuncSetAttribute(
        attention_step_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
    non_portable_set = true;
  }
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(S, B, 1);
  config.blockDim = dim3(kThreads, 1, 1);
  config.dynamicSmemBytes = smem;
  config.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&config, attention_step_kernel, qp, lp,
                                       mp, v, memory, mask, scale, T, A, D, R,
                                       stage_rows, ctx, w);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// An empty kernel launched as attention_step would launch it: S x B blocks
// in clusters of S, or one plain block for S = 0.
extern "C" int attention_empty_launch(int B, int S, void* stream) {
  if (S == 0) {
    empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(0);
    return (int)cudaGetLastError();
  }
  if (S > 8 && !empty_non_portable_set) {
    cudaError_t err = cudaFuncSetAttribute(
        empty_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
    empty_non_portable_set = true;
  }
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(S, B, 1);
  config.blockDim = dim3(kThreads, 1, 1);
  config.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&config, empty_kernel, 0);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
