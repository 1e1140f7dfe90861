// WaveRNN sample loops for Hopper (sm_90a): the whole autoregressive
// generation of every row in ONE cooperative launch. One templated body
// serves the three TPU sample-loop kernels; the arm, and whether it carries
// the RNN state in and out, are compile-time flags.
//
// Replaces:
//   ARM_FUSED      (B1): wavernn_tpu/ops/pallas_gen.py, _make_fused_kernel
//                  (called through generate_pallas_fused), the TPU kernel
//                  that upsamples its own conditioning from frame-rate folded
//                  rows and runs the sample loop;
//   ARM_FUSED with STATE (B4b): the same maker with with_state=True (called
//                  through generate_pallas_fused_with_state), B1 resuming
//                  from and snapshotting the RNN state: the exact-seam
//                  passes on frame-rate folds;
//   ARM_MAT        (B3, with B4a's state I/O): pallas_gen.py, _make_kernel
//                  (with_state False and True, called through
//                  generate_pallas and generate_pallas_with_state), the
//                  materialized sample loop that streams sample-rate
//                  conditioning in and can resume from and snapshot the RNN
//                  state;
//   ARM_V2         (B10): wavernn_tpu/ops/pallas_gen2.py, _make_kernel
//                  (called through generate_pallas_v2), the sample loop on
//                  five conditioning streams pre-projected outside the loop
//                  into gate space, six products a step.
//
// What it computes, per row b and sample t:
//   B1, t = c*hop + i (chunk c, phase i), once per chunk c (hoisted, as the
//   TPU kernel does):
//     p_j   = frame[c+j][:n_mels] @ W_Imel          j < K  (mel taps)
//     base  = a1 @ W_Ia1 + b_I,  gi2a = a2 @ W_i2a + b_i2,
//     f1a   = a3 @ W_1a + b_1,   f2a  = a4 @ W_2a + b_2   (a = frame[c+aux_tap])
//   B3, the row cond[t, b] = [mel | a1 | a2 | a3 | a4] at every step:
//     base  = [mel | a1] @ W_Ic + b_I, and gi2a, f1a, f2a as above from its
//     a2..a4, computed inside the launch for a span of steps ahead as one
//     product over (span*B) rows into the workspace (they do not depend on x)
//   per sample:
//     inp = base + x*w_Ix (+ sum_j phi[j][i] * p_j in B1)
//     h1  = GRU(inp, h1);   xr = inp + h1
//     h2  = GRU([xr|a2], h2); x2 = xr + h2
//     hf  = relu(fc2(relu(fc1(x2))));  logits = fc3(hf)
//     x   = MOL sample (Gumbel mixture pick + inverse-CDF logistic, log-scale
//           clamped at log 1e-14) or RAW Gumbel-argmax, from injected
//           uniforms or the counter hash below.
//   State (B3, B4b): (h1, h2, x) start from the given state (zeros when
//   none), and the state entering step snapshot_at (the final state when it
//   is T) is written out, so two chained launches equal one. B1 is the same
//   arm without the state code, so its steps carry no test for it.
//   B10, from the streams i, gi1, gi2, f1, f2 (rows t*B + b, bf16 or f32)
//   and the folded vectors wxw1 = W_i1 w_Ix, wxw2 = W_i2x w_Ix:
//     h1  = GRU gates(gi1[t] + x*wxw1, h1 @ W_h1 + b_h1);  xr = i[t] + x*w_Ix + h1
//     h2  = GRU gates(gi2[t] + x*wxw2 + h1 @ W_i2x, h2 @ W_h2 + b_h2)
//     x2  = xr + h2;  hf = relu(fc2(relu(x2 @ W_1x + f1[t])) + f2[t]), etc.
//   No conditioning product runs in the launch, so it has no span barrier.
//
// What bounds it: latency, not bytes or FLOPs. Counted once, the work is
// small for the card (each step multiplies the ~3.69M core weights, 7.4 MB
// in bf16, by a batch of only B rows), but the steps are a chain: every
// sample depends on the previous one, and five stages of a step depend on
// each other across the whole grid. PERF.md has the measured split between
// the fixed per-step cost and the part that grows with the row count.
//
// Design: one persistent cooperative launch, one block per SM. Each block
// owns a slice of the output columns of every layer (a warp per column,
// lanes across the reduction axis with 16-byte weight loads); a grid barrier
// separates the dependent stages of one step: gru1 | gru2 | fc1 | fc2 |
// fc3+sample. Weights stay in device memory (they fit in the 50 MB L2);
// the small per-step activation vectors are staged in shared memory per
// block. The recurrent state ping-pongs between two buffers so a
// stage never overwrites what another block is still reading. B3's
// conditioning products run once per span of steps, with one more barrier;
// its workspace is per span, so nothing but the output and the conditioning
// stream grows with T. B10 reads each step's rows of its five streams
// (9.2 KB a row in bf16 at R = FC = 512) where the gates and the fc layers
// need them, and runs five barriers a step, as B1 does; its stage 1 has
// one product (h1 @ W_h1) where B1 and B3 have two.
//
// B9, the sparse arm (a runtime choice per matrix, LoopArgs::sp): replaces
// wavernn_tpu/ops/pallas_gen.py, _sparse_mm, the block-sparse product of a
// pruned model's per-step matrices inside both TPU kernels (B3's body and
// B1's, packing in _pack_block_sparse / pack_sparse). For each of the six
// per-step matrices (wi1, wh1, wi2x, wh2, w1x, w2x) that ops/cuda_gen.py
// packed, the kernel reads its live (128 output rows x bw input columns)
// blocks, in CSR order per 128-row block, instead of the dense matrix, and
// runs only their multiply-adds; fc3 and the conditioning products stay
// dense, and the gate arithmetic runs for every unit as before. What bounds
// it: the same chain of dependent steps and grid barriers as the dense arm
// (the weights it reads shrink ~16x at 93.75 % block sparsity; the barriers
// and the staging of each step's rows into every block do not). What the
// design does about that: nothing yet; it measures how much of a step the
// dot products were. Its lanes keep the dense arm's lane-to-k mapping (lane
// l sums the 8-column chunks c = l mod 32 in increasing c, each in element
// order), and a dead block adds exactly +0 in the dense arm, so every
// output equals the dense kernel's on the same masked weights bit for bit.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int BT = 8;  // rows per shared-memory tile
constexpr float LOG_SCALE_MIN = -32.23619130191664f;  // log(1e-14)
constexpr float MOL_U_SCALE = (float)(1.0 - 2e-5);

// the body's arms
constexpr int ARM_FUSED = 0;  // B1, B4b: conditioning from frame-rate folds
constexpr int ARM_MAT = 1;    // B3: sample-rate conditioning rows
constexpr int ARM_V2 = 2;     // B10: pre-projected gate-space streams

}  // namespace

// One packed matrix of the sparse arm (null row_ptr: the matrix is dense).
// Row block rb (128 rows) holds blocks row_ptr[rb] .. row_ptr[rb+1] - 1, in
// increasing input block col[e]; block e is val[e] (128, bw) row-major.
struct SparseMat {
  const int32_t* row_ptr;  // (rows/128 + 1,)
  const int32_t* col;      // (L,)
  const void* val;         // (L, 128, bw)  WT
  int64_t bw;              // input columns per block: 128, or 8 (legacy)
};

constexpr int N_SPARSE = 6;  // wi1, wh1, wi2x, wh2, w1x, w2x

// Mirrored field for field by ops/cuda_gen.py (ctypes): 8-byte fields only.
struct LoopArgs {
  const float* frames;  // B1: (nf_loc, B, C) f32, C = n_mels + 4A
  const float* phi;     // B1: (K, hop) f32
  const float* cond;    // B3: (T, B, C) f32
  const float* noise;   // (T, B, NU) f32 injected uniforms, or null
  const void* w_imel;   // (R, n_mels)   WT
  const void* w_ia1;    // (R, A)        WT
  const float* w_ix;    // (R,)
  const float* b_i;     // (R,)
  const void* wi1;      // (3R, R)       WT
  const void* wh1;      // (3R, R)       WT
  const float* bi1;     // (3R,)
  const float* bh1;     // (3R,)
  const void* wi2x;     // (3R, R)       WT
  const void* wi2a;     // (3R, A)       WT
  const void* wh2;      // (3R, R)       WT
  const float* bi2;     // (3R,)
  const float* bh2;     // (3R,)
  const void* w1x;      // (FC, R)       WT
  const void* w1a;      // (FC, A)       WT
  const float* b1;      // (FC,)
  const void* w2x;      // (FC, FC)      WT
  const void* w2a;      // (FC, A)       WT
  const float* b2;      // (FC,)
  const void* w3;       // (NC, FC)      WT
  const float* b3;      // (NC,)
  const float* h1_0;    // B3, B4b: (B, R) initial state, or null for zeros
  const float* h2_0;    // (B, R)
  const float* x_0;     // (B,)
  float* snap_h1;       // B3, B4b: (B, R) the state entering snapshot_at
  float* snap_h2;       // (B, R)
  float* snap_x;        // (B,)
  float* out;           // (B, T) f32
  float* work;          // zeroed workspace, see Work below
  const void* s_i;      // B10: (T, B, R) streams, bf16 or f32 (stream_bf16)
  const void* s_gi1;    // B10: (T, B, 3R)
  const void* s_gi2;    // B10: (T, B, 3R)
  const void* s_f1;     // B10: (T, B, FC)
  const void* s_f2;     // B10: (T, B, FC)
  const float* wxw1;    // B10: (3R,)
  const float* wxw2;    // B10: (3R,)
  int64_t B, R, FC, A, n_mels, NC, K, hop, fold_chunks, aux_tap;
  int64_t T, span, snapshot_at;  // B3: steps, steps per conditioning span
  int64_t mol, seed, bf16, stream_bf16;
  SparseMat sp[N_SPARSE];  // B9: the packed per-step matrices, or nulls
};

namespace {

struct Work {  // views into LoopArgs::work (floats); S = span (B1: 1)
  float *ps, *base, *gi2a, *f1a, *f2a, *h1, *h2, *xr, *x2, *hf1, *hf2, *x;
  __device__ Work(float* w, int B, int R, int FC, int K, int S) {
    const size_t SB = (size_t)S * B;
    ps = w;                            // (K, B, R)  B1's mel taps
    base = ps + (size_t)K * B * R;     // (S, B, R)
    gi2a = base + SB * R;              // (S, B, 3R)
    f1a = gi2a + 3 * SB * R;           // (S, B, FC)
    f2a = f1a + SB * FC;               // (S, B, FC)
    h1 = f2a + SB * FC;                // (2, B, R) ping-pong
    h2 = h1 + 2 * B * R;               // (2, B, R) ping-pong
    xr = h2 + 2 * B * R;               // (B, R)
    x2 = xr + B * R;                   // (B, R)
    hf1 = x2 + B * R;                  // (B, FC)
    hf2 = hf1 + B * FC;                // (B, FC)
    x = hf2 + B * FC;                  // (B,) previous sample
  }
};

__device__ __forceinline__ void load8(const float* p, float (&w)[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
  w[4] = b.x; w[5] = b.y; w[6] = b.z; w[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&w)[8]) {
  const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(h[e]);
    w[2 * e] = f.x;
    w[2 * e + 1] = f.y;
  }
}

__device__ __forceinline__ float load1(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}

// B10: element i of a conditioning stream, bf16 or f32
__device__ __forceinline__ float load_stream(const void* p, size_t i,
                                             bool bf16) {
  return bf16 ? load1((const __nv_bfloat16*)p + i) : load1((const float*)p + i);
}

__device__ __forceinline__ void load8_shared(const float* p, float (&a)[8]) {
  const float4 u = reinterpret_cast<const float4*>(p)[0];
  const float4 v = reinterpret_cast<const float4*>(p)[1];
  a[0] = u.x; a[1] = u.y; a[2] = u.z; a[3] = u.w;
  a[4] = v.x; a[5] = v.y; a[6] = v.z; a[7] = v.w;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float sigmoidf(float x) { return 1.f / (1.f + expf(-x)); }

// Warp-wide dot products of one output unit j against a tile of nb rows:
// NA gate rows of `wa` against s_a, NB gate rows of `wb` against s_b.
// Row g of a matrix is row g*gstride + j, of length n (n % 8 == 0); the
// tiles are (nb, n) row-major in shared memory. Every lane ends with the
// full sums. A row's sums do not depend on the other rows of its tile.
template <int NA, int NB, typename WT>
__device__ __forceinline__ void warp_dots(const WT* __restrict__ wa,
                                          const WT* __restrict__ wb, int j,
                                          int gstride, int n,
                                          const float* s_a, const float* s_b,
                                          int nb, float (&acc)[NA + NB][BT]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int g = 0; g < NA + NB; ++g)
#pragma unroll
    for (int b = 0; b < BT; ++b) acc[g][b] = 0.f;
  for (int k0 = lane * 8; k0 < n; k0 += 256) {
    float w[NA + NB][8];
#pragma unroll
    for (int g = 0; g < NA; ++g)
      load8(wa + ((size_t)g * gstride + j) * n + k0, w[g]);
#pragma unroll
    for (int g = 0; g < NB; ++g)
      load8(wb + ((size_t)g * gstride + j) * n + k0, w[NA + g]);
#pragma unroll
    for (int b = 0; b < BT; ++b) {
      if (b < nb) {
        float a[8];
        load8_shared(s_a + b * n + k0, a);
#pragma unroll
        for (int g = 0; g < NA; ++g)
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[g][b] = fmaf(w[g][e], a[e], acc[g][b]);
        if (NB > 0) {
          load8_shared(s_b + b * n + k0, a);
#pragma unroll
          for (int g = NA; g < NA + NB; ++g)
#pragma unroll
            for (int e = 0; e < 8; ++e) acc[g][b] = fmaf(w[g][e], a[e], acc[g][b]);
        }
      }
    }
  }
#pragma unroll
  for (int g = 0; g < NA + NB; ++g)
#pragma unroll
    for (int b = 0; b < BT; ++b)
      if (b < nb) acc[g][b] = warp_sum(acc[g][b]);
}

// B9: warp_dots' sums for NG gate rows g*gstride + j of a packed matrix,
// over its live blocks only. Lane l takes, of each live block, the one
// 8-column chunk c with c = l (mod 32) if the block holds it: the chunks
// warp_dots gives lane l, in the same increasing order, so each lane's sum
// differs from warp_dots' only by the +0 terms of dead blocks.
template <int NG, typename WT>
__device__ __forceinline__ void sparse_dots(const SparseMat& sp, int j,
                                            int gstride, int n, const float* s,
                                            int nb, float (&acc)[NG][BT]) {
  const int lane = threadIdx.x & 31;
  const WT* val = (const WT*)sp.val;
  const int bw = (int)sp.bw, cpb = bw / 8;  // 8-column chunks per block
#pragma unroll
  for (int g = 0; g < NG; ++g) {
#pragma unroll
    for (int b = 0; b < BT; ++b) acc[g][b] = 0.f;
    const int r = g * gstride + j;
    const int rb = r >> 7, ro = r & 127;
    const int e1 = __ldg(sp.row_ptr + rb + 1);
    for (int e = __ldg(sp.row_ptr + rb); e < e1; ++e) {
      const int c0 = __ldg(sp.col + e) * cpb;
      const int c = c0 + ((lane - c0) & 31);
      if (c >= c0 + cpb) continue;
      float w[8];
      load8(val + ((size_t)e * 128 + ro) * bw + (c - c0) * 8, w);
#pragma unroll
      for (int b = 0; b < BT; ++b) {
        if (b < nb) {
          float a[8];
          load8_shared(s + b * n + c * 8, a);
#pragma unroll
          for (int k = 0; k < 8; ++k) acc[g][b] = fmaf(w[k], a[k], acc[g][b]);
        }
      }
    }
  }
#pragma unroll
  for (int g = 0; g < NG; ++g)
#pragma unroll
    for (int b = 0; b < BT; ++b)
      if (b < nb) acc[g][b] = warp_sum(acc[g][b]);
}

// The per-step products of one stage: warp_dots on the dense matrices, the
// sparse arm on the packed ones. Each gate row's sum is independent of the
// others, so splitting the two matrices changes no sum.
template <int NA, int NB, typename WT>
__device__ __forceinline__ void step_dots(const WT* wa, const SparseMat& sa,
                                          const WT* wb, const SparseMat& sb,
                                          int j, int gstride, int n,
                                          const float* s_a, const float* s_b,
                                          int nb, float (&acc)[NA + NB][BT]) {
  if (!sa.row_ptr && (NB == 0 || !sb.row_ptr)) {
    warp_dots<NA, NB>(wa, wb, j, gstride, n, s_a, s_b, nb, acc);
    return;
  }
  float t[NA][BT];
  if (sa.row_ptr) sparse_dots<NA, WT>(sa, j, gstride, n, s_a, nb, t);
  else warp_dots<NA, 0>(wa, wa, j, gstride, n, s_a, s_a, nb, t);
#pragma unroll
  for (int g = 0; g < NA; ++g)
#pragma unroll
    for (int b = 0; b < BT; ++b) acc[g][b] = t[g][b];
  if constexpr (NB > 0) {
    float u[NB][BT];
    if (sb.row_ptr) sparse_dots<NB, WT>(sb, j, gstride, n, s_b, nb, u);
    else warp_dots<NB, 0>(wb, wb, j, gstride, n, s_b, s_b, nb, u);
#pragma unroll
    for (int g = 0; g < NB; ++g)
#pragma unroll
      for (int b = 0; b < BT; ++b) acc[NA + g][b] = u[g][b];
  }
}

// Warp-wide dot of a weight row (any length) with a read-only vector.
template <typename WT>
__device__ __forceinline__ float warp_dot_scalar(const WT* __restrict__ w,
                                                 const float* __restrict__ v,
                                                 int n) {
  float acc = 0.f;
  for (int k = threadIdx.x & 31; k < n; k += 32) acc = fmaf(load1(w + k), __ldg(v + k), acc);
  return warp_sum(acc);
}

// Counter-based uniforms, production noise. ops/cuda_gen.py holds the same
// hash in PyTorch so the plain version can replay the exact draws.
__device__ __forceinline__ uint32_t lowbias32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7feb352du;
  x ^= x >> 15;
  x *= 0x846ca68bu;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ float counter_uniform(uint32_t key, uint32_t ctr,
                                                 bool mol) {
  const float u = __fmul_rn((float)(lowbias32(ctr ^ key) >> 8),
                            5.9604644775390625e-08f);  // 2^-24
  return mol ? __fadd_rn(__fmul_rn(u, MOL_U_SCALE), 1e-5f) : __fadd_rn(u, 1e-9f);
}

// argmax over the warp with the first index winning ties (jnp/torch argmax)
__device__ __forceinline__ void warp_argmax(float& v, int& i) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, o);
    const int oi = __shfl_xor_sync(0xffffffffu, i, o);
    if (ov > v || (ov == v && oi < i)) {
      v = ov;
      i = oi;
    }
  }
}

// B3, B4b: copy the state entering the current step (block 0 only; other
// blocks write only the other ping-pong buffer and x after later barriers).
__device__ void snapshot(const LoopArgs& a, const float* h1, const float* h2,
                         const float* x, int B, int R) {
  if (blockIdx.x != 0) return;
  for (int e = threadIdx.x; e < B * R; e += THREADS) {
    a.snap_h1[e] = __ldcg(h1 + e);
    a.snap_h2[e] = __ldcg(h2 + e);
  }
  for (int b = threadIdx.x; b < B; b += THREADS) a.snap_x[b] = __ldcg(x + b);
}

template <typename WT, int ARM, bool STATE>
__global__ void __launch_bounds__(THREADS, 1) sample_loop(LoopArgs a) {
  constexpr bool FUSED = ARM == ARM_FUSED, V2 = ARM == ARM_V2;
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float smem[];
  const int B = (int)a.B, R = (int)a.R, FC = (int)a.FC, A = (int)a.A;
  const int n_mels = (int)a.n_mels, NC = (int)a.NC, K = FUSED ? (int)a.K : 0;
  const int hop = (int)a.hop, C = n_mels + 4 * A;
  const int T = FUSED ? (int)(a.fold_chunks * a.hop) : (int)a.T;
  // B10 has no conditioning to project: its one span is the whole launch
  const int span = FUSED ? hop : V2 ? T : (int)a.span;
  const bool mol = a.mol != 0, sbf = a.stream_bf16 != 0;
  const int nr = NC / 3;
  const int NU = mol ? nr + 1 : NC;
  const uint32_t key = lowbias32((uint32_t)a.seed);
  const int DM = R > FC ? R : FC;
  float* s_a = smem;            // (BT, DM)
  float* s_b = smem + BT * DM;  // (BT, R)
  Work wk(a.work, B, R, FC, K, FUSED ? 1 : V2 ? 0 : span);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // units spread over blocks first, so every SM gets a share of each stage
  const int gw = warp * gridDim.x + blockIdx.x;
  const int nw = WARPS * gridDim.x;
  const int gt = threadIdx.x * gridDim.x + blockIdx.x, nt = THREADS * gridDim.x;

  const WT* w_imel = (const WT*)a.w_imel;
  const WT* w_ia1 = (const WT*)a.w_ia1;
  const WT* wi1 = (const WT*)a.wi1;
  const WT* wh1 = (const WT*)a.wh1;
  const WT* wi2x = (const WT*)a.wi2x;
  const WT* wi2a = (const WT*)a.wi2a;
  const WT* wh2 = (const WT*)a.wh2;
  const WT* w1x = (const WT*)a.w1x;
  const WT* w1a = (const WT*)a.w1a;
  const WT* w2x = (const WT*)a.w2x;
  const WT* w2a = (const WT*)a.w2a;
  const WT* w3 = (const WT*)a.w3;

  if constexpr (STATE) {
    // resume from the given state (the workspace arrives zeroed); the first
    // conditioning span's barrier orders these writes before step 0
    for (int e = gt; e < B * R; e += nt) {
      if (a.h1_0) wk.h1[e] = a.h1_0[e];
      if (a.h2_0) wk.h2[e] = a.h2_0[e];
    }
    if (a.x_0)
      for (int b = gt; b < B; b += nt) wk.x[b] = a.x_0[b];
  }

  for (int t0 = 0; t0 < T; t0 += span) {
    const int n_steps = min(span, T - t0);
    if constexpr (FUSED) {
      // ---- per-chunk conditioning: mel taps and the four aux projections ----
      const int c = t0 / hop;
      const int n_units = K * R + R + 3 * R + 2 * FC;
      for (int u = gw; u < n_units; u += nw) {
        for (int b = 0; b < B; ++b) {
          if (u < K * R) {
            const int j = u / R, col = u % R;
            const float* fr = a.frames + ((size_t)(c + j) * B + b) * C;
            const float v = warp_dot_scalar(w_imel + (size_t)col * n_mels, fr, n_mels);
            if (lane == 0) wk.ps[((size_t)j * B + b) * R + col] = v;
            continue;
          }
          const float* aux = a.frames + ((size_t)(c + a.aux_tap) * B + b) * C + n_mels;
          int v = u - K * R;
          if (v < R) {
            const float s = warp_dot_scalar(w_ia1 + (size_t)v * A, aux, A);
            if (lane == 0) wk.base[(size_t)b * R + v] = s + a.b_i[v];
            continue;
          }
          v -= R;
          if (v < 3 * R) {
            const float s = warp_dot_scalar(wi2a + (size_t)v * A, aux + A, A);
            if (lane == 0) wk.gi2a[(size_t)b * 3 * R + v] = s + a.bi2[v];
            continue;
          }
          v -= 3 * R;
          if (v < FC) {
            const float s = warp_dot_scalar(w1a + (size_t)v * A, aux + 2 * A, A);
            if (lane == 0) wk.f1a[(size_t)b * FC + v] = s + a.b1[v];
            continue;
          }
          v -= FC;
          const float s = warp_dot_scalar(w2a + (size_t)v * A, aux + 3 * A, A);
          if (lane == 0) wk.f2a[(size_t)b * FC + v] = s + a.b2[v];
        }
      }
    } else if constexpr (ARM == ARM_MAT) {
      // ---- the span's conditioning: base, gi2a, f1a, f2a for its
      // n_steps * B rows of cond (row q = i*B + b is step t0 + i) ----
      const int rows = n_steps * B;
      const int n_units = R + 3 * R + 2 * FC;
      for (int u = gw; u < n_units; u += nw) {
        const WT *w0, *w1 = nullptr;
        int n0 = A, off0, off1 = 0, stride;
        float bias;
        float* dst;
        int v = u;
        if (v < R) {
          w0 = w_imel + (size_t)v * n_mels; n0 = n_mels; off0 = 0;
          w1 = w_ia1 + (size_t)v * A; off1 = n_mels;
          bias = a.b_i[v]; dst = wk.base + v; stride = R;
        } else if ((v -= R) < 3 * R) {
          w0 = wi2a + (size_t)v * A; off0 = n_mels + A;
          bias = a.bi2[v]; dst = wk.gi2a + v; stride = 3 * R;
        } else if ((v -= 3 * R) < FC) {
          w0 = w1a + (size_t)v * A; off0 = n_mels + 2 * A;
          bias = a.b1[v]; dst = wk.f1a + v; stride = FC;
        } else {
          v -= FC;
          w0 = w2a + (size_t)v * A; off0 = n_mels + 3 * A;
          bias = a.b2[v]; dst = wk.f2a + v; stride = FC;
        }
        for (int q = 0; q < rows; ++q) {
          const float* row = a.cond + ((size_t)t0 * B + q) * C;
          float s = warp_dot_scalar(w0, row + off0, n0);
          if (w1) s += warp_dot_scalar(w1, row + off1, A);
          if (lane == 0) dst[(size_t)q * stride] = s + bias;
        }
      }
    }
    if constexpr (!V2) grid.sync();

    for (int i = 0; i < n_steps; ++i) {
      const int t = t0 + i;
      // B1 keeps one conditioning row per chunk; B3 one per step of the span
      const size_t ci = ARM == ARM_MAT ? (size_t)i * B : 0;
      float* h1_cur = wk.h1 + (size_t)(t & 1) * B * R;
      float* h1_nxt = wk.h1 + (size_t)((t + 1) & 1) * B * R;
      float* h2_cur = wk.h2 + (size_t)(t & 1) * B * R;
      float* h2_nxt = wk.h2 + (size_t)((t + 1) & 1) * B * R;
      if constexpr (STATE) {
        if (t == a.snapshot_at) snapshot(a, h1_cur, h2_cur, wk.x, B, R);
      }

      if constexpr (V2) {
        // ---- B10 stage 1: GRU1 on the gi1 stream, xr ----
        for (int b0 = 0; b0 < B; b0 += BT) {
          const int nb = min(BT, B - b0);
          __syncthreads();
          for (int e = threadIdx.x; e < nb * R; e += THREADS)
            s_a[e] = __ldcg(h1_cur + (size_t)b0 * R + e);
          __syncthreads();
          for (int j = gw; j < R; j += nw) {
            float acc[3][BT];
            step_dots<3, 0>(wh1, a.sp[1], wh1, a.sp[1], j, R, R, s_a, s_a, nb,
                            acc);
            if (lane < nb) {
              float hr = 0.f, hz = 0.f, hn = 0.f;
#pragma unroll
              for (int b = 0; b < BT; ++b)
                if (b == lane) {
                  hr = acc[0][b]; hz = acc[1][b]; hn = acc[2][b];
                }
              const int b = lane;
              const size_t row = (size_t)t * B + b0 + b;
              const float xv = __ldcg(wk.x + b0 + b);
              const float* g1 = a.wxw1;
              const float gr = load_stream(a.s_gi1, row * 3 * R + j, sbf) + xv * g1[j];
              const float gz = load_stream(a.s_gi1, row * 3 * R + R + j, sbf) + xv * g1[R + j];
              const float gn = load_stream(a.s_gi1, row * 3 * R + 2 * R + j, sbf) + xv * g1[2 * R + j];
              const float r = sigmoidf(gr + (hr + a.bh1[j]));
              const float z = sigmoidf(gz + (hz + a.bh1[R + j]));
              const float n = tanhf(gn + r * (hn + a.bh1[2 * R + j]));
              const float h = (1.f - z) * n + z * s_a[b * R + j];
              h1_nxt[(size_t)(b0 + b) * R + j] = h;
              const float inp = load_stream(a.s_i, row * R + j, sbf) + xv * a.w_ix[j];
              wk.xr[(size_t)(b0 + b) * R + j] = inp + h;
            }
          }
        }
        grid.sync();

        // ---- B10 stage 2: GRU2 on the gi2 stream and the new h1, x2 ----
        for (int b0 = 0; b0 < B; b0 += BT) {
          const int nb = min(BT, B - b0);
          __syncthreads();
          for (int e = threadIdx.x; e < nb * R; e += THREADS) {
            const size_t g = (size_t)b0 * R + e;
            s_a[e] = __ldcg(h1_nxt + g);
            s_b[e] = __ldcg(h2_cur + g);
          }
          __syncthreads();
          for (int j = gw; j < R; j += nw) {
            float acc[6][BT];
            step_dots<3, 3>(wi2x, a.sp[2], wh2, a.sp[3], j, R, R, s_a, s_b,
                            nb, acc);
            if (lane < nb) {
              float gr = 0.f, gz = 0.f, gn = 0.f, hr = 0.f, hz = 0.f, hn = 0.f;
#pragma unroll
              for (int b = 0; b < BT; ++b)
                if (b == lane) {
                  gr = acc[0][b]; gz = acc[1][b]; gn = acc[2][b];
                  hr = acc[3][b]; hz = acc[4][b]; hn = acc[5][b];
                }
              const int b = lane;
              const size_t row = (size_t)t * B + b0 + b;
              const float xv = __ldcg(wk.x + b0 + b);
              const float* g2 = a.wxw2;
              // (stream + x*wxw2) + h1 @ W_i2x, the TPU kernel's order
              gr = (load_stream(a.s_gi2, row * 3 * R + j, sbf) + xv * g2[j]) + gr;
              gz = (load_stream(a.s_gi2, row * 3 * R + R + j, sbf) + xv * g2[R + j]) + gz;
              gn = (load_stream(a.s_gi2, row * 3 * R + 2 * R + j, sbf) + xv * g2[2 * R + j]) + gn;
              const float r = sigmoidf(gr + (hr + a.bh2[j]));
              const float z = sigmoidf(gz + (hz + a.bh2[R + j]));
              const float n = tanhf(gn + r * (hn + a.bh2[2 * R + j]));
              const float h = (1.f - z) * n + z * s_b[b * R + j];
              h2_nxt[(size_t)(b0 + b) * R + j] = h;
              wk.x2[(size_t)(b0 + b) * R + j] =
                  __ldcg(wk.xr + (size_t)(b0 + b) * R + j) + h;
            }
          }
        }
        grid.sync();
      } else {
        // ---- stage 1: inp, GRU1, xr ----
        for (int b0 = 0; b0 < B; b0 += BT) {
          const int nb = min(BT, B - b0);
          __syncthreads();
          for (int e = threadIdx.x; e < nb * R; e += THREADS) {
            const int b = b0 + e / R, k = e % R;
            float v = __ldcg(wk.base + (ci + b) * R + k) + __ldcg(wk.x + b) * a.w_ix[k];
            if constexpr (FUSED) {
              for (int j = 0; j < K; ++j)
                v = v + a.phi[j * hop + i] * __ldcg(wk.ps + ((size_t)j * B + b) * R + k);
            }
            s_a[e] = v;
            s_b[e] = __ldcg(h1_cur + (size_t)b * R + k);
          }
          __syncthreads();
          for (int j = gw; j < R; j += nw) {
            float acc[6][BT];
            step_dots<3, 3>(wi1, a.sp[0], wh1, a.sp[1], j, R, R, s_a, s_b, nb,
                            acc);
            if (lane < nb) {
              float gr = 0.f, gz = 0.f, gn = 0.f, hr = 0.f, hz = 0.f, hn = 0.f;
#pragma unroll
              for (int b = 0; b < BT; ++b)
                if (b == lane) {
                  gr = acc[0][b]; gz = acc[1][b]; gn = acc[2][b];
                  hr = acc[3][b]; hz = acc[4][b]; hn = acc[5][b];
                }
              const int b = lane;
              const float r = sigmoidf((gr + a.bi1[j]) + (hr + a.bh1[j]));
              const float z = sigmoidf((gz + a.bi1[R + j]) + (hz + a.bh1[R + j]));
              const float n = tanhf((gn + a.bi1[2 * R + j]) + r * (hn + a.bh1[2 * R + j]));
              const float h = (1.f - z) * n + z * s_b[b * R + j];
              h1_nxt[(size_t)(b0 + b) * R + j] = h;
              wk.xr[(size_t)(b0 + b) * R + j] = s_a[b * R + j] + h;
            }
          }
        }
        grid.sync();

        // ---- stage 2: GRU2 on [xr | a2], x2 ----
        for (int b0 = 0; b0 < B; b0 += BT) {
          const int nb = min(BT, B - b0);
          __syncthreads();
          for (int e = threadIdx.x; e < nb * R; e += THREADS) {
            const size_t g = (size_t)b0 * R + e;
            s_a[e] = __ldcg(wk.xr + g);
            s_b[e] = __ldcg(h2_cur + g);
          }
          __syncthreads();
          for (int j = gw; j < R; j += nw) {
            float acc[6][BT];
            step_dots<3, 3>(wi2x, a.sp[2], wh2, a.sp[3], j, R, R, s_a, s_b, nb,
                            acc);
            if (lane < nb) {
              float gr = 0.f, gz = 0.f, gn = 0.f, hr = 0.f, hz = 0.f, hn = 0.f;
#pragma unroll
              for (int b = 0; b < BT; ++b)
                if (b == lane) {
                  gr = acc[0][b]; gz = acc[1][b]; gn = acc[2][b];
                  hr = acc[3][b]; hz = acc[4][b]; hn = acc[5][b];
                }
              const int b = lane;
              const float* ga = wk.gi2a + (ci + b0 + b) * 3 * R;  // a2 terms + bi2
              const float r = sigmoidf((gr + __ldcg(ga + j)) + (hr + a.bh2[j]));
              const float z = sigmoidf((gz + __ldcg(ga + R + j)) + (hz + a.bh2[R + j]));
              const float n = tanhf((gn + __ldcg(ga + 2 * R + j)) + r * (hn + a.bh2[2 * R + j]));
              const float h = (1.f - z) * n + z * s_b[b * R + j];
              h2_nxt[(size_t)(b0 + b) * R + j] = h;
              wk.x2[(size_t)(b0 + b) * R + j] = s_a[b * R + j] + h;
            }
          }
        }
        grid.sync();
      }

      // ---- stages 3 and 4: fc1, fc2 (ReLU) ----
      for (int layer = 0; layer < 2; ++layer) {
        const float* src = layer == 0 ? wk.x2 : wk.hf1;
        float* dst = layer == 0 ? wk.hf1 : wk.hf2;
        const float* add = (layer == 0 ? wk.f1a : wk.f2a) + ci * FC;
        const void* add_v2 = layer == 0 ? a.s_f1 : a.s_f2;  // B10's stream
        const WT* w = layer == 0 ? w1x : w2x;
        const SparseMat sw = layer == 0 ? a.sp[4] : a.sp[5];
        const int n = layer == 0 ? R : FC;
        for (int b0 = 0; b0 < B; b0 += BT) {
          const int nb = min(BT, B - b0);
          __syncthreads();
          for (int e = threadIdx.x; e < nb * n; e += THREADS)
            s_a[e] = __ldcg(src + (size_t)b0 * n + e);
          __syncthreads();
          for (int j = gw; j < FC; j += nw) {
            float acc[1][BT];
            step_dots<1, 0>(w, sw, w, sw, j, FC, n, s_a, s_a, nb, acc);
            if (lane < nb) {
              float s = 0.f;
#pragma unroll
              for (int b = 0; b < BT; ++b)
                if (b == lane) s = acc[0][b];
              const size_t o = (size_t)(b0 + lane) * FC + j;
              const float c = V2 ? load_stream(add_v2, (size_t)t * B * FC + o, sbf)
                                 : __ldcg(add + o);
              dst[o] = fmaxf(s + c, 0.f);
            }
          }
        }
        grid.sync();
      }

      // ---- stage 5: fc3 and the sample, one block per row ----
      for (int b = blockIdx.x; b < B; b += gridDim.x) {
        float* s_h = s_a;        // (FC,)
        float* s_l = s_a + FC;   // (NC,)
        __syncthreads();
        for (int e = threadIdx.x; e < FC; e += THREADS)
          s_h[e] = __ldcg(wk.hf2 + (size_t)b * FC + e);
        __syncthreads();
        for (int cls = warp; cls < NC; cls += WARPS) {
          float acc[1][BT];
          warp_dots<1, 0>(w3, w3, cls, NC, FC, s_h, s_h, 1, acc);
          if (lane == 0) s_l[cls] = acc[0][0] + a.b3[cls];
        }
        __syncthreads();
        if (warp == 0) {
          const size_t ctr0 = ((size_t)t * B + b) * NU;
          auto uniform = [&](int k) {
            return a.noise ? __ldg(a.noise + ctr0 + k)
                           : counter_uniform(key, (uint32_t)(ctr0 + k), mol);
          };
          float best = -INFINITY;
          int idx = 0x7fffffff;
          float sample;
          if (mol) {
            if (lane < nr) {
              best = s_l[lane] - logf(-logf(uniform(lane)));
              idx = lane;
            }
            warp_argmax(best, idx);
            const float mean = s_l[nr + idx];
            const float log_s = fmaxf(s_l[2 * nr + idx], LOG_SCALE_MIN);
            const float us = uniform(nr);
            sample = mean + expf(log_s) * (logf(us) - logf(1.f - us));
            sample = fminf(fmaxf(sample, -1.f), 1.f);
          } else {
            for (int k = lane; k < NC; k += 32) {
              const float v = s_l[k] + -logf(-logf(uniform(k)));
              if (v > best) {
                best = v;
                idx = k;
              }
            }
            warp_argmax(best, idx);
            sample = 2.f * (float)idx / ((float)NC - 1.f) - 1.f;
          }
          if (lane == 0) {
            a.out[(size_t)b * T + t] = sample;
            wk.x[b] = sample;
          }
        }
      }
      grid.sync();
    }
  }
  if constexpr (STATE) {
    if (a.snapshot_at == T)
      snapshot(a, wk.h1 + (size_t)(T & 1) * B * R, wk.h2 + (size_t)(T & 1) * B * R,
               wk.x, B, R);
  }
}

size_t shared_bytes(const LoopArgs& a) {
  const int64_t dm = a.R > a.FC ? a.R : a.FC;
  const int64_t tiles = (int64_t)BT * (dm + a.R);
  const int64_t head = a.FC + a.NC;  // stage 5 reuses the tiles
  return (size_t)(tiles > head ? tiles : head) * sizeof(float);
}

int launch(const void* fn, const LoopArgs* args, void* stream) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const size_t smem = shared_bytes(*args);
  e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, THREADS, smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  LoopArgs a = *args;
  void* kargs[] = {&a};
  // one block per SM: within the co-residency limit per_sm * sms
  e = cudaLaunchCooperativeKernel(fn, dim3(sms), dim3(THREADS), kargs, smem,
                                  (cudaStream_t)stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Floats of workspace a launch needs (zero-filled by the caller): K mel taps
// (B1; 0 otherwise), `span` rows of conditioning products per row (B1: 1;
// B10: 0).
int64_t wr_sample_loop_work_floats(int64_t B, int64_t R, int64_t FC, int64_t K,
                                   int64_t span) {
  return K * B * R + span * B * (R + 3 * R + 2 * FC) + 4 * B * R + 2 * B * R
         + 2 * B * FC + B;
}

// B1: launches the fused loop on `stream`; returns the CUDA error code
// (0 = launched).
int wr_sample_loop_fused(const LoopArgs* args, void* stream) {
  return launch(args->bf16 ? (const void*)sample_loop<__nv_bfloat16, ARM_FUSED, false>
                           : (const void*)sample_loop<float, ARM_FUSED, false>,
                args, stream);
}

// B4b: the fused loop with state I/O.
int wr_sample_loop_fused_state(const LoopArgs* args, void* stream) {
  return launch(args->bf16 ? (const void*)sample_loop<__nv_bfloat16, ARM_FUSED, true>
                           : (const void*)sample_loop<float, ARM_FUSED, true>,
                args, stream);
}

// B3: launches the materialized loop with state I/O on `stream`.
int wr_sample_loop_materialized(const LoopArgs* args, void* stream) {
  return launch(args->bf16 ? (const void*)sample_loop<__nv_bfloat16, ARM_MAT, true>
                           : (const void*)sample_loop<float, ARM_MAT, true>,
                args, stream);
}

// B10: the loop on pre-projected streams.
int wr_sample_loop_v2(const LoopArgs* args, void* stream) {
  return launch(args->bf16 ? (const void*)sample_loop<__nv_bfloat16, ARM_V2, false>
                           : (const void*)sample_loop<float, ARM_V2, false>,
                args, stream);
}

}  // extern "C"
