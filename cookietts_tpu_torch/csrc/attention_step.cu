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
//
// The bf16 form (attention_step_bf16): qp, lp, mp and memory are bf16, the
// rest as in the f32 form; every value is widened to f32 as it is read and
// all the math is f32, as the JAX package's Pallas path computes on the
// bf16-rounded operands cast to f32 (cookietts_tpu/ops/attention.py:164-170,
// pallas_kernels.py:102-107); ctx and w are written in f32 (the caller
// rounds ctx to bf16). Its rows are half the bytes, so a stage holds more
// of them in the same shared memory. The staging works in bytes: a row
// segment is copied from the 4-byte word that holds its first element to
// the one that holds its last, so a bf16 row that starts or ends mid-word
// also reads the 2 bytes beside it (in the same word, never used); no other
// byte of a masked row is read.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
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

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ float ldg_f32(const T* p) { return to_f32(__ldg(p)); }

// Bytes of a staged row segment of n values of T: room for the source's
// shift within 16 bytes (0-12 bytes) and, for bf16, for the 2 bytes before
// and after it in its end words, rounded up to whole 16-byte words.
template <typename T>
__host__ __device__ __forceinline__ int seg_bytes(int n) {
  return (n * (int)sizeof(T) + 12 + (sizeof(T) == 2 ? 4 : 0) + 15) / 16 * 16;
}

// The byte offset, mod 16, of a global address: a segment is staged at
// this offset inside its slot, so source and destination agree mod 16 bytes.
__device__ __forceinline__ int shift_of(const void* p) {
  return (int)(reinterpret_cast<uintptr_t>(p) & 15);
}

__device__ __forceinline__ void cp_async4(char* dst, const char* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async16(char* dst, const char* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
}

// One warp copies the n values at src into slot (seg_bytes<T>(n) bytes),
// from the 4-byte word that holds the first to the one that holds the
// last: 4-byte copies up to the first 16-byte boundary and after the last,
// 16-byte copies between. The values start at slot + shift_of(src).
template <typename T>
__device__ __forceinline__ void copy_segment(char* slot, const T* src_t,
                                             int n, int lane) {
  const char* p = reinterpret_cast<const char*>(src_t);
  const char* src = p - (reinterpret_cast<uintptr_t>(p) & 3);
  const int words = ((int)(p - src) + n * (int)sizeof(T) + 3) >> 2;
  const int sh = shift_of(src) >> 2;
  char* dst = slot + 4 * sh;
  const int head = min(words, (4 - sh) & 3);
  const int body = (words - head) >> 2;
  const int tail = words - head - 4 * body;
  if (lane < head) cp_async4(dst + 4 * lane, src + 4 * lane);
  for (int k = lane; k < body; k += 32)
    cp_async16(dst + 4 * (head + 4 * k), src + 4 * (head + 4 * k));
  if (lane < tail) {
    const int j = head + 4 * body + lane;
    cp_async4(dst + 4 * j, src + 4 * j);
  }
}

// The staged row of src inside slot.
template <typename T>
__device__ __forceinline__ const T* staged(const char* slot, const T* src) {
  return reinterpret_cast<const T*>(slot + shift_of(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

struct Layout {
  int row;        // bytes of one staged row: lp, mp, memory segments
  int fixed;      // floats before the staged rows (a whole 16-byte word)
  size_t bytes;   // dynamic shared memory of a block
};

template <typename T>
__host__ __device__ inline Layout layout(int A, int D, int R, int stage_rows) {
  Layout l;
  l.row = 2 * seg_bytes<T>(A) + seg_bytes<T>(D);
  l.fixed = (2 * A + 2 * R + stage_rows + kMisc + D + 3) / 4 * 4;
  l.bytes = sizeof(float) * (size_t)l.fixed + (size_t)stage_rows * l.row;
  return l;
}

// E: float (the f32 form) or __nv_bfloat16 (qp, lp, mp, memory in bf16).
template <typename E>
__global__ void __launch_bounds__(kThreads)
attention_step_kernel(const E* __restrict__ qp, const E* __restrict__ lp,
                      const E* __restrict__ mp, const float* __restrict__ v,
                      const E* __restrict__ memory,
                      const unsigned char* __restrict__ mask,
                      const float* __restrict__ scale, int T, int A, int D,
                      int R, int stage_rows, float* __restrict__ ctx,
                      float* __restrict__ w) {
  extern __shared__ __align__(16) float smem[];
  const Layout lay = layout<E>(A, D, R, stage_rows);
  float* q_s = smem;                                   // [A]
  float* v_s = q_s + A;                                // [A]
  float* e_s = v_s + A;                                // [R] energies
  int* idx_s = reinterpret_cast<int*>(e_s + R);        // [R] admitted rows
  float* p_s = reinterpret_cast<float*>(idx_s + R);    // [stage_rows]
  float* misc = p_s + stage_rows;                      // [kMisc]
  float* part_s = misc + kMisc;                        // [D] partial context
  char* buf = reinterpret_cast<char*>(smem + lay.fixed);  // [stage_rows][row]
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
    q_s[a] = ldg_f32(qp + (size_t)b * A + a);
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
      char* slot = buf + (size_t)i * lay.row;
      copy_segment(slot, lp + t * A, A, lane);
      copy_segment(slot + seg_bytes<E>(A), mp + t * A, A, lane);
      copy_segment(slot + 2 * seg_bytes<E>(A), memory + t * D, D, lane);
    }
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    for (int i = warp; i < n; i += kWarps) {
      const int j = idx_s[first + i];
      const char* slot = buf + (size_t)i * lay.row;
      const E* l_row = staged(slot, lp + (row0 + j) * A);
      const E* m_row = staged(slot + seg_bytes<E>(A), mp + (row0 + j) * A);
      float acc = 0.f;
      for (int a = lane; a < A; a += 32)
        acc += v_s[a] * tanhf(q_s[a] + to_f32(l_row[a]) + to_f32(m_row[a]));
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
        const E* mem_row = staged(buf + (size_t)i * lay.row + 2 * seg_bytes<E>(A),
                                  memory + (row0 + idx_s[first + i]) * D);
        acc += p_s[i] * to_f32(mem_row[d]);
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
      for (int j = 0; j < n_rows; ++j) acc += ldg_f32(memory + (row0 + j) * D + d);
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

bool empty_non_portable_set = false;

// What a form's kernel has been given: the shared memory it may use, and
// clusters past 8 blocks.
template <typename E>
struct Attributes {
  static int max_smem;
  static bool non_portable;
};
template <typename E> int Attributes<E>::max_smem = 48 * 1024;
template <typename E> bool Attributes<E>::non_portable = false;

template <typename E>
int launch(const E* qp, const E* lp, const E* mp, const float* v,
           const E* memory, const unsigned char* mask, const float* scale,
           int B, int T, int A, int D, int S, int R, int stage_rows,
           float* ctx, float* w, void* stream) {
  if (S < 1 || S > kClusterMax || R < 1 || (long long)S * R < T ||
      stage_rows < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = layout<E>(A, D, R, stage_rows).bytes;
  if ((int)smem > Attributes<E>::max_smem) {
    cudaError_t err = cudaFuncSetAttribute(
        attention_step_kernel<E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    Attributes<E>::max_smem = (int)smem;
  }
  if (S > 8 && !Attributes<E>::non_portable) {
    cudaError_t err = cudaFuncSetAttribute(
        attention_step_kernel<E>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
    Attributes<E>::non_portable = true;
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
  cudaError_t err = cudaLaunchKernelEx(&config, attention_step_kernel<E>, qp,
                                       lp, mp, v, memory, mask, scale, T, A,
                                       D, R, stage_rows, ctx, w);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int attention_step_smem(int A, int D, int R, int stage_rows) {
  return (int)layout<float>(A, D, R, stage_rows).bytes;
}

extern "C" int attention_step_smem_bf16(int A, int D, int R, int stage_rows) {
  return (int)layout<__nv_bfloat16>(A, D, R, stage_rows).bytes;
}

extern "C" int attention_step(const float* qp, const float* lp, const float* mp,
                              const float* v, const float* memory,
                              const unsigned char* mask, const float* scale,
                              int B, int T, int A, int D, int S, int R,
                              int stage_rows, float* ctx, float* w,
                              void* stream) {
  return launch(qp, lp, mp, v, memory, mask, scale, B, T, A, D, S, R,
                stage_rows, ctx, w, stream);
}

// The bf16 form: qp, lp, mp and memory bf16; v, scale, ctx and w f32.
extern "C" int attention_step_bf16(const __nv_bfloat16* qp,
                                   const __nv_bfloat16* lp,
                                   const __nv_bfloat16* mp, const float* v,
                                   const __nv_bfloat16* memory,
                                   const unsigned char* mask,
                                   const float* scale, int B, int T, int A,
                                   int D, int S, int R, int stage_rows,
                                   float* ctx, float* w, void* stream) {
  return launch(qp, lp, mp, v, memory, mask, scale, B, T, A, D, S, R,
                stage_rows, ctx, w, stream);
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
