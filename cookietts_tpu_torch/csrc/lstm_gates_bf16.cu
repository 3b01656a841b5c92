// One LSTM gate step in bf16, fused into one launch: the [B,F] x [F,4H]
// gate product, the gate nonlinearities and the cell update, pre-zoneout.
//
// Replaces the TPU kernel cookietts_tpu/ops/pallas_kernels.py:lstm_gates_step
// (:236, body _lstm_kernel :195) as the JAX package runs it with bf16
// operands (cookietts_tpu/ops/lstm.py:64-70, pallas_kernels.py:253-256):
// xh, W and the bias bf16, c_prev, c' and h' f32, all math f32:
//   gates = xh @ W + bias
//   c' = sigmoid(f + 1) * c + sigmoid(i) * tanh(g)
//   h' = sigmoid(o) * tanh(c')
//
// Bound on the H100: bytes. W is nearly all of them: 28.8 MB at F=2816,
// H=1280, 15.7 and 9.4 MB for the two 768-wide cells, 16.2 us a decode
// step at 3.35 TB/s. At decode batch the product is small; what the first
// bf16 form (a copy of the f32 form's plan) lost was latency: each block's
// slice of W was a few 16 KB stages, so filling and draining a cp.async
// ring, a round trip of partial sums through device memory, a fence and a
// ticket counter were most of a block's life.
//
// Design:
// - Grid (S, col_tiles, groups) in clusters of S blocks along x. A block
//   owns 64 columns of each of the four gate blocks (256 columns of W) and
//   one of the S runs of W's rows (whole 64-row stages, split as evenly
//   as the S runs allow); a cluster holds every run of one column tile, so
//   every element of W belongs to exactly one block. lstm_gates_bf16_plan
//   (ops/hopper_kernels.py) picks S so that the clusters are all resident
//   at once.
// - TMA from the first instruction: one producer thread issues, per stage,
//   four 2-D boxes of W (64 rows x 64 columns of one gate, 128-byte
//   swizzled) and one box of xh (the stage's 64 columns of up to 128 batch
//   rows), all completing on the stage's mbarrier, for as many stages as
//   the ring holds (up to 8, as shared memory allows); consumers release a
//   stage with a second barrier and the producer refills it.
// - Eight consumer warps run the product on the tensor cores
//   (mma.sync.m16n8k16, bf16 operands, f32 accumulators): W's columns are
//   M (ldmatrix.trans from the swizzled boxes, conflict-free), the batch N
//   (8 to 128 rows, zero-padded by the box past B), so W is read once for
//   every batch row up to 128 and the products of bf16 operands are exact
//   in f32, as in JAX's Pallas product.
// - Split-K on chip: each block leaves its [rows][256] f32 partial sums in
//   its own shared memory; after a cluster barrier, block r sums every
//   block's partials for its share of the (row, column) pairs over
//   distributed shared memory in rank order 0..S-1 (the same bits on every
//   call), adds the bias and runs the f32 epilogue; a second cluster
//   barrier keeps every block alive until the others have read it. No
//   partials in device memory, no fence, no ticket counter.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <string.h>

#include "bf16_mma.cuh"
#include "tma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kConsumerWarps = 8;
constexpr int kThreads = (kConsumerWarps + 1) * 32;   // + one producer warp
constexpr int kCols = 64;                 // columns of each gate a block owns
constexpr int kRows = 64;                 // rows of W a stage holds
constexpr int kGateBox = kRows * kCols * 2;           // 8 KB
constexpr int kWBytes = 4 * kGateBox;                 // 32 KB
constexpr int kMaxStages = 8;
constexpr int kClusterMax = 16;
constexpr int kSmemMax = 232448;

// NB = 8 NT batch rows a pass (16 to 128).
__host__ __device__ constexpr int stage_bytes(int NB) {
  return kWBytes + NB * kRows * 2;
}

// Dynamic shared memory of a launch: 1 KB of alignment slack, the ring (or
// the partial sums, which reuse it), the barriers.
__host__ __device__ inline int smem_bytes(int NB, int ring) {
  const int ring_bytes = ring * stage_bytes(NB);
  const int part_bytes = NB * 4 * kCols * 4;
  return 1024 + (ring_bytes > part_bytes ? ring_bytes : part_bytes) +
         2 * kMaxStages * 8;
}

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.f / (1.f + expf(-x));
}

// Byte offset of the 16-byte chunk `chunk` of row `row` in a box of
// 128-byte rows under the 128-byte swizzle.
__device__ __forceinline__ int swz(int row, int chunk) {
  return row * 128 + ((chunk ^ (row & 7)) << 4);
}

template <int NT>
__global__ void __launch_bounds__(kThreads, 1)
lstm_gates_bf16_kernel(const __grid_constant__ CUtensorMap w_map,
                       const __grid_constant__ CUtensorMap x_map,
                       const __nv_bfloat16* __restrict__ bias,
                       const float* __restrict__ c_prev, int B, int H,
                       int n_stages, int ring, float* __restrict__ c_out,
                       float* __restrict__ h_out) {
  using namespace bf16mma;
  constexpr int NB = 8 * NT;
  constexpr int kStage = stage_bytes(NB);
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = tma::align1024(smem_raw);
  const int ring_bytes = ring * kStage;
  const int part_bytes = NB * 4 * kCols * 4;
  uint64_t* full = reinterpret_cast<uint64_t*>(
      smem + (ring_bytes > part_bytes ? ring_bytes : part_bytes));
  uint64_t* empty = full + kMaxStages;
  float* part = reinterpret_cast<float*>(smem);      // [NB][4 * kCols]

  cg::cluster_group cluster = cg::this_cluster();
  const int S = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int j0 = blockIdx.y * kCols;
  const int b0 = blockIdx.z * NB;
  // this block's stages: an even split of n_stages over the S ranks
  const int s_begin = (int)((long long)rank * n_stages / S);
  const int n = (int)((long long)(rank + 1) * n_stages / S) - s_begin;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < ring; ++s) {
      tma::mbar_init(&full[s], 1);
      tma::mbar_init(&empty[s], kConsumerWarps);
    }
    tma::fence_mbar_init();
  }
  __syncthreads();

  float acc[2][NT][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.f;

  if (warp == kConsumerWarps) {
    // the producer: every stage of the block's run, as the ring frees
    if (lane == 0) {
      tma::prefetch_map(&w_map);
      tma::prefetch_map(&x_map);
      for (int i = 0; i < n; ++i) {
        const int s = i % ring;
        const uint32_t ph = (uint32_t)(i / ring) & 1u;
        if (i >= ring) tma::mbar_wait(&empty[s], ph ^ 1u);
        tma::mbar_expect_tx(&full[s], kStage);
        unsigned char* st = smem + s * kStage;
        const int f = (s_begin + i) * kRows;
#pragma unroll
        for (int g = 0; g < 4; ++g)
          tma::load_2d(st + g * kGateBox, &w_map, &full[s], g * H + j0, f);
        tma::load_2d(st + kWBytes, &x_map, &full[s], f, b0);
      }
    }
  } else {
    // consumer warp w: gate w / 2, columns (w % 2) * 32 + [0, 32) of it
    const int gate = warp >> 1, cw = (warp & 1) * 32;
    const int q = lane >> 3, r = lane & 7;
    for (int i = 0; i < n; ++i) {
      const int s = i % ring;
      tma::mbar_wait(&full[s], (uint32_t)(i / ring) & 1u);
      const unsigned char* wb = smem + s * kStage + gate * kGateBox;
      const unsigned char* xb = smem + s * kStage + kWBytes;
#pragma unroll
      for (int kk = 0; kk < kRows; kk += 16) {
        uint32_t a[2][4], bf[NT][2];
        const int krow = kk + r + ((q >> 1) << 3);
#pragma unroll
        for (int m = 0; m < 2; ++m)
          ldmatrix_x4_trans(a[m], wb + swz(krow, ((cw + 16 * m) >> 3) + (q & 1)));
#pragma unroll
        for (int j = 0; j < NT; j += 2) {
          uint32_t v[4];
          const int nrow = 8 * j + r + ((q >> 1) << 3);
          ldmatrix_x4(v, xb + swz(nrow, (kk >> 3) + (q & 1)));
          bf[j][0] = v[0];
          bf[j][1] = v[1];
          bf[j + 1][0] = v[2];
          bf[j + 1][1] = v[3];
        }
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int j = 0; j < NT; ++j) mma_bf16(acc[m][j], a[m], bf[j][0], bf[j][1]);
      }
      __syncwarp();
      if (lane == 0) tma::mbar_arrive(&empty[s]);
    }
  }

  // every stage has landed and been read: the ring becomes the partials
  __syncthreads();
  if (warp < kConsumerWarps) {
    const int gate = warp >> 1, cw = (warp & 1) * 32;
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = gate * kCols + cw + 16 * m + g + (e >= 2 ? 8 : 0);
          const int row = 8 * j + 2 * t + (e & 1);
          part[row * 4 * kCols + col] = acc[m][j][e];
        }
  }
  cluster.sync();

  // this rank's share of the (row, column) pairs (a run of them), summed
  // in rank order
  const int nb = min(NB, B - b0);
  const int share = (nb * kCols + S - 1) / S;
  const int i1 = min(nb * kCols, (rank + 1) * share);
  for (int i = rank * share + threadIdx.x; i < i1; i += kThreads) {
    const int row = i / kCols, c = i - row * kCols;
    const int j = j0 + c;
    if (j >= H) continue;
    float gs[4] = {0.f, 0.f, 0.f, 0.f};
    for (int src = 0; src < S; ++src) {
      const float* p = cluster.map_shared_rank(part, src) + row * 4 * kCols + c;
#pragma unroll
      for (int k = 0; k < 4; ++k) gs[k] += p[k * kCols];
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) gs[k] += __bfloat162float(bias[k * H + j]);
    const size_t o = (size_t)(b0 + row) * H + j;
    const float cn = sigmoidf(gs[1] + 1.f) * c_prev[o] + sigmoidf(gs[0]) * tanhf(gs[2]);
    c_out[o] = cn;
    h_out[o] = sigmoidf(gs[3]) * tanhf(cn);
  }
  cluster.sync();      // no block leaves while another reads its partials
}

struct Attributes {
  int max_smem = 48 * 1024;
  bool non_portable = false;
};

template <int NT>
int launch(const CUtensorMap& w_map, const __nv_bfloat16* xh,
           const __nv_bfloat16* bias, const float* c_prev, int B, int F,
           int H, int S, int ring, float* c_out, float* h_out,
           cudaStream_t st) {
  constexpr int NB = 8 * NT;
  static Attributes attrs;
  const int n_stages = (F + kRows - 1) / kRows;
  const int smem = smem_bytes(NB, ring);
  if (S < 1 || S > kClusterMax || S > n_stages || ring < 1 ||
      ring > kMaxStages || smem > kSmemMax)
    return (int)cudaErrorInvalidValue;
  // xh [B, F]: boxes of 64 columns x NB rows, zeros past F and B
  CUtensorMap x_map;
  const cuuint64_t dims[2] = {(cuuint64_t)F, (cuuint64_t)B};
  const cuuint64_t strides[1] = {(cuuint64_t)F * 2};
  const cuuint32_t box[2] = {(cuuint32_t)kRows, (cuuint32_t)NB};
  int err = tma::encode_bf16(&x_map, xh, 2, dims, strides, box,
                             CU_TENSOR_MAP_SWIZZLE_128B);
  if (err) return err;
  if (smem > attrs.max_smem) {
    cudaError_t e = cudaFuncSetAttribute(
        lstm_gates_bf16_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
    attrs.max_smem = smem;
  }
  if (S > 8 && !attrs.non_portable) {
    cudaError_t e = cudaFuncSetAttribute(
        lstm_gates_bf16_kernel<NT>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return (int)e;
    attrs.non_portable = true;
  }
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(S, (H + kCols - 1) / kCols, (B + NB - 1) / NB);
  config.blockDim = dim3(kThreads, 1, 1);
  config.dynamicSmemBytes = smem;
  config.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&config, lstm_gates_bf16_kernel<NT>, w_map,
                                     x_map, bias, c_prev, B, H, n_stages, ring,
                                     c_out, h_out);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// The tensor map of W [F, 4H] (bf16, H even, 16-byte aligned) in the
// kernel's boxes, written into `map` (128 bytes); the caller caches it
// with the weight (ops/hopper_kernels.py).
extern "C" int lstm_gates_bf16_weight_map(const __nv_bfloat16* W, int F, int H,
                                          void* map) {
  if (H % 2 != 0 || ((size_t)W & 15) != 0) return (int)cudaErrorInvalidValue;
  const cuuint64_t dims[2] = {(cuuint64_t)4 * H, (cuuint64_t)F};
  const cuuint64_t strides[1] = {(cuuint64_t)8 * H};
  const cuuint32_t box[2] = {(cuuint32_t)kCols, (cuuint32_t)kRows};
  CUtensorMap m;                      // the encoder wants 64-byte alignment
  const int err = tma::encode_bf16(&m, W, 2, dims, strides, box,
                                   CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == 0) memcpy(map, &m, sizeof m);
  return err;
}

// One gate step. xh [B, F] (F a multiple of 8), bias [4H] bf16; c_prev,
// c_out, h_out [B, H] f32; w_map from lstm_gates_bf16_weight_map. The plan
// (nt: 8 nt batch rows a pass, 2 to 16; S: the cluster; ring: stages in
// flight) comes from lstm_gates_bf16_plan in ops/hopper_kernels.py.
extern "C" int lstm_gates_bf16(const void* w_map, const __nv_bfloat16* xh,
                               const __nv_bfloat16* bias, const float* c_prev,
                               int B, int F, int H, int nt, int S, int ring,
                               float* c_out, float* h_out, void* stream) {
  if (F % 8 != 0 || B < 1 || ((size_t)xh & 15) != 0)
    return (int)cudaErrorInvalidValue;
  CUtensorMap map;                    // a 64-byte aligned copy
  memcpy(&map, w_map, sizeof map);
  cudaStream_t st = (cudaStream_t)stream;
  switch (nt) {
    case 2:
      return launch<2>(map, xh, bias, c_prev, B, F, H, S, ring, c_out, h_out, st);
    case 4:
      return launch<4>(map, xh, bias, c_prev, B, F, H, S, ring, c_out, h_out, st);
    case 8:
      return launch<8>(map, xh, bias, c_prev, B, F, H, S, ring, c_out, h_out, st);
    case 16:
      return launch<16>(map, xh, bias, c_prev, B, F, H, S, ring, c_out, h_out, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
