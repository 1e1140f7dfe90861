// Tacotron decoder training recurrence for Hopper (sm_90a), teacher
// forcing (B6: taco_tf_fwd / taco_tf_bwd) and attention forcing (B7:
// taco_af_fwd / taco_af_bwd): forward and backward, each one cooperative
// persistent launch over all G = steps / r decoder groups, and the
// backward's weight gradients. One templated body per direction; the AF
// arm's additions are compiled only into the taco_af_* kernels.
//
// Replaces: wavernn_tpu/ops/pallas_taco_train.py, _make_fwd_kernel(af=False)
// (:80, called at :328 through _fwd_impl) and _make_bwd_kernel(af=False)
// (:350, called at :747 through _core_bwd), the TPU kernels behind the
// custom VJP _core; and the same makers with af=True (:328 through
// _core_af :802, :925 through _core_af_bwd :836). ops/cuda_taco_train.py
// holds the wrappers, the torch.autograd.Functions and the plain versions
// (core_ref, core_bwd_ref, core_af_ref, core_af_bwd_ref).
//
// Attention forcing (AF) differs from TF in three places:
//   * the prenet runs inside the recurrence, on the last mel frame of the
//     previous group (zeros at g = 0), with pre-scaled dropout keep-masks
//     dm1 / dm2: one block per utterance, after LSTM2's barrier, computes
//     prev = x2 @ wm[last frame]^T, p1 = relu(w1 prev + b1) dm1 and
//     pre = relu(w2 p1 + b2) dm2 (weights from L2), then one more barrier:
//     six per group instead of five. prev, p1 and pre are written as
//     streams for the backward;
//   * the context is sum_t aref[g, b, t] enc_t; the scores, the cumulative
//     and the previous attention still come from the student's own LSA;
//   * the backward emits daref = dctx . enc_t instead of adding it to the
//     scores' cotangent, and the utterance block of the attention stage
//     also runs the prenet backward: dpre = dgi @ awi[:, E:], dp2 = dpre dm2
//     [pre > 0], dp1 = (dp2 @ w2) dm1 [p1 > 0], Dprev = dp1 @ w1, added to
//     the last frame of group g-1's mel cotangent (the wrapper hands the
//     kernel a copy of dmel, so the mel_proj gradient reduction reads the
//     effective cotangent). No extra barrier: the next read of that row is
//     stage 1 of group g-1, behind the attention stage's barrier.
//
// What it computes, per group g, batched over B utterances (float32):
//   ah   = GRUCell([ctx | pre_g], ah)                    attention rnn
//   q    = W ah + (W.b + L.b)
//   loc  = W01 [cumulative taps | attention taps]        conv(2->32, k 31,
//          pad 15) composed with L, zero padding at each utterance's ends
//   sig  = sigmoid(v . tanh(loc + encp + q)),  s = sig / sum_t sig  over the
//          batch's padded T_text (no per-utterance mask), sum guarded > 0
//   ctx  = sum_t s_t enc_t;  cumulative += s;  attention = s
//   x0   = rnn_input([ctx | ah]);  two residual LSTMCells, zoneout on h only
//          (h = z h_prev + (1 - z) h_new);  mel_g = x2 @ wm^T (r frames)
// The forward writes mel (G, B, F), scores (G, B, T) and, when training,
// the streams the backward reads (cumulative before the update, q, the
// normaliser, ah, GRU [r|z|n|hn], ctx, x0, x1, x2, both LSTMs' gate
// activations [i|f|g|o], c1, h1, c2, h2).
// The backward sweeps the groups in reverse, carrying dah, dctx, dh1, dc1,
// dh2, dc2 and the cumulative/attention cotangents through the location
// conv; it emits d(pre), d(encoder_seq), d(encoder_seq_proj), and writes the
// gate cotangents of every group, from which hand-written reduction
// kernels (wgrad_gemm, colsum, reduce_rows) form every weight gradient.
//
// What bounds it on this card. At B 32, T_text 150, G 100 (r 7) one forward
// does about 50 GFLOP (0.74 ms at 67 TF/s float32) and moves about 0.18 GB;
// the backward about 114 GFLOP (1.7 ms). The true limit is the chain of G
// dependent groups, each five stages that need the previous stage's whole
// output, so every group pays five grid barriers and L2 round trips, and
// the attention stage runs on one block per utterance (32 of 132 SMs).
//
// Design, for that chain:
//   * one cooperative launch per direction, one block per SM; five
//     grid.sync() per group (the mel projection shares the next group's
//     first interval, and the GRU backward runs inside the per-utterance
//     attention block);
//   * matrix stages: a warp per output unit with all its gates, lanes along
//     the reduction (16-byte weight loads through the read-only path), the
//     stage's inputs for all batch rows staged once per block in shared
//     memory, 8 batch rows per pass;
//   * attention: one block per utterance computes q, the energies, the
//     normalisation and the context with no barrier; a thread per attention
//     unit runs the location conv from register windows of 16 positions
//     (the composed location weight, 62 x D, stays in shared memory for the
//     whole launch); q, the context and dq @ wq give each warp 8
//     independent rows; the backward recomputes the energies with the same
//     code and order, keeps the group's location-weight gradient in shared
//     memory (a column per thread) and sums the conv's input cotangents
//     over the units in shared memory, with no global scratch;
//   * weight gradients: each utterance block owns its rows of d(enc),
//     d(encp) and its partial location/v gradients, and the matrix
//     gradients are one tiled reduction over G*B rows per weight, so no
//     atomics and a deterministic order;
//   * state ping-pongs between two buffers, read through L2 (__ldcg).
// Not yet used: tensor cores, TMA, clusters, several blocks per utterance.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int RB = 8;                 // batch rows per warp pass
constexpr int CONV_K = 31;
constexpr int CONV_HALF = 15;
constexpr int NTAP = 2 * CONV_K;      // cumulative taps then attention taps
constexpr int TC = 16;                // text positions per attention chunk
constexpr int TH = 8;                 // of them per register pass
constexpr int64_t SMEM_FLOATS = 200 * 1024 / 4;

__host__ __device__ inline int64_t up4(int64_t n) { return (n + 3) / 4 * 4; }
}  // namespace

// Mirrored field for field by ops/cuda_taco_train.py (ctypes): 8-byte fields.
struct TfFwdArgs {
  const float *pre, *zm1, *zm2, *enc, *encp;       // (G,B,P2) (G,B,L)x2 (B,T,E) (B,T,D)
  const float *awi, *abi, *awh, *abh;              // (3D, E+P2) (3D) (3D, D) (3D)
  const float *wq, *qb, *w01t, *v;                 // (D, D) (D) (62, D) (D)
  const float *wr, *br;                            // (L, E+D) (L)
  const float *l1wi, *l1wh, *l1b, *l2wi, *l2wh, *l2b;  // (4L, L) x2 (4L) ...
  const float *wm;                                 // (F, L)
  float *mel, *scores;                             // (G,B,F) (G,B,T)
  float *s_cum, *s_q, *s_div, *s_ah, *s_gru, *s_ctx, *s_x0, *s_x1, *s_x2;
  float *s_g1, *s_g2, *s_c1, *s_h1, *s_c2, *s_h2;
  float *work;                                     // zeroed, see FwdWork
  int64_t G, B, T, E, D, P2, L, F, save, bc;
};

struct TfBwdArgs {
  const float *pre, *zm1, *zm2, *enc, *encp, *scores, *dmel, *dsc;
  const float *wqT, *w01t, *v;
  const float *wmT, *l2wiT, *l2whT, *l1wiT, *l1whT, *wrT, *awiT, *awhT;
  const float *s_cum, *s_q, *s_div, *s_ah, *s_gru, *s_ctx, *s_x0, *s_x1, *s_x2;
  const float *s_g1, *s_g2, *s_c1, *s_h1, *s_c2, *s_h2;
  float *c_dgi, *c_dgh, *c_dq, *c_dx0, *c_dg1, *c_dg2;   // cotangent streams
  float *dpre, *denc, *dencp, *pw01, *pv;                // zeroed accumulators
  float *dawi, *dabi, *dawh, *dabh, *dwq, *dqb, *dw01, *dv, *dwr, *dbr;
  float *dl1wi, *dl1wh, *dl1b, *dl2wi, *dl2wh, *dl2b, *dwm;
  float *work;                                           // zeroed, see BwdWork
  int64_t G, B, T, E, D, P2, L, F, bc;
};

// The AF arm's extra operands (B7). With them TfFwdArgs.pre is s_pre, which
// the forward writes; TfBwdArgs.pre is the forward's s_pre and
// TfBwdArgs.dmel the writable copy `dmel` below; TfBwdArgs.dpre is unused.
struct AfFwdArgs {
  const float *aref, *dm1, *dm2;                   // (G,B,T) (G,B,P1) (G,B,P2)
  const float *w1, *b1, *w2, *b2;                  // (P1, NM) (P1) (P2, P1) (P2)
  float *s_prev, *s_p1, *s_pre;                    // (G,B,NM) (G,B,P1) (G,B,P2)
  int64_t P1, NM;
};

struct AfBwdArgs {
  const float *aref, *dm1, *dm2, *w1T, *w2T;       // ... (NM, P1) (P1, P2)
  const float *s_prev, *s_p1;
  float *dmel;                                     // (G,B,F), gains Dprev
  float *c_dp1, *c_dp2, *daref;                    // (G,B,P1) (G,B,P2) (G,B,T)
  float *dw1, *db1, *dw2, *db2;
  int64_t P1, NM;
};

namespace {

struct Take {
  float* base;
  int64_t size = 0;
  __host__ __device__ float* operator()(int64_t n) {
    float* p = base ? base + size : nullptr;
    size += up4(n);
    return p;
  }
};

struct FwdWork {
  float *ah[2], *ctx[2], *h1[2], *c1[2], *h2[2], *c2[2], *cum[2], *att[2];
  float *x0, *x1, *x2;
  int64_t size;
  __host__ __device__ FwdWork(float* w, const TfFwdArgs& a) {
    Take take{w};
    const int64_t B = a.B;
    for (int i = 0; i < 2; ++i) {
      ah[i] = take(B * a.D); ctx[i] = take(B * a.E);
      h1[i] = take(B * a.L); c1[i] = take(B * a.L);
      h2[i] = take(B * a.L); c2[i] = take(B * a.L);
      cum[i] = take(B * a.T); att[i] = take(B * a.T);
    }
    x0 = take(B * a.L); x1 = take(B * a.L); x2 = take(B * a.L);
    size = take.size;
  }
};

struct BwdWork {
  float *dah, *dctx, *dh1, *dc1, *dh2, *dc2, *dcum, *datt;   // carries
  float *wz1, *wz2, *dx1, *dx2, *dctx_t, *dahp, *dtz;
  int64_t size;
  __host__ __device__ BwdWork(float* w, const TfBwdArgs& a) {
    Take take{w};
    const int64_t B = a.B;
    dah = take(B * a.D); dctx = take(B * a.E);
    dh1 = take(B * a.L); dc1 = take(B * a.L); dh2 = take(B * a.L); dc2 = take(B * a.L);
    dcum = take(B * a.T); datt = take(B * a.T);
    wz1 = take(B * a.L); wz2 = take(B * a.L); dx1 = take(B * a.L); dx2 = take(B * a.L);
    dctx_t = take(B * a.E); dahp = take(B * a.D); dtz = take(B * a.D);
    size = take.size;
  }
};

// The attention stages run one thread per attention unit d (D <= THREADS)
// over chunks of TC text positions, with TH positions per register pass.
// cumw/attw hold an utterance's cumulative and previous attention with 15
// zeros before and at least 15 + TC after (win_floats), so the register
// windows of a chunk read in bounds.
__host__ __device__ inline int64_t win_floats(int64_t T) {
  return up4(T + 2 * CONV_HALF + TC);
}

// shared-memory floats: the location weight (62 x D) for the whole launch,
// then the larger of the staged rows and the attention scratch
__host__ __device__ inline int64_t red4_floats(int64_t E) {
  return 4 * (E / 4 > THREADS ? E / 4 : THREADS);
}
constexpr int64_t LSA_RED = WARPS * TC + TC + WARPS;   // red16, u, red
constexpr int64_t LOC_RED = (WARPS * (TC + CONV_K - 1) + 3) / 4 * 4;
__host__ __device__ inline int64_t lsa_fwd_floats(int64_t D, int64_t T, int64_t E) {
  return 3 * up4(D) + 2 * win_floats(T) + up4(T) + LSA_RED + red4_floats(E);
}
__host__ __device__ inline int64_t lsa_bwd_floats(int64_t D, int64_t T, int64_t E) {
  return 4 * up4(D) + 4 * win_floats(T) + 2 * up4(T) + TC + up4(E) + LSA_RED + LOC_RED +
         NTAP * D;
}
// AF: the forward's prenet block (x2, prev, p1, p2) and the backward's
// prenet chain after the attention stage's own floats (dgi, dpre, dp1,
// Dprev)
inline int64_t af_fwd_floats(const TfFwdArgs& a, const AfFwdArgs& x) {
  return up4(a.L) + up4(x.NM) + up4(x.P1) + up4(a.P2);
}
inline int64_t af_bwd_floats(const TfBwdArgs& a, const AfBwdArgs& x) {
  return up4(3 * a.D) + up4(a.P2) + up4(x.P1) + up4(x.NM);
}
inline int64_t fwd_row_floats(const TfFwdArgs& a) {
  int64_t w = a.E + a.P2 + a.D;
  if (a.E + a.D > w) w = a.E + a.D;
  if (2 * a.L > w) w = 2 * a.L;
  return w;
}
inline int64_t bwd_row_floats(const TfBwdArgs& a) {
  int64_t w = a.F;
  if (4 * a.L > w) w = 4 * a.L;
  if (a.L > w) w = a.L;
  if (6 * a.D > w) w = 6 * a.D;
  return w;
}

// ---- typed access for the resident bodies' storage type S (float, or
// bfloat16 in their bf16 instantiations): every load widens to float, every
// store rounds to nearest even; rnd<S> is the rounding a value takes when it
// is stored in S. For float each is the plain access it replaces.
typedef __nv_bfloat16 bf16_t;
template <typename S>
__host__ __device__ __forceinline__ const S* cs(const float* p) {
  return reinterpret_cast<const S*>(p);
}
template <typename S>
__host__ __device__ __forceinline__ S* ms(float* p) {
  return reinterpret_cast<S*>(p);
}
__device__ __forceinline__ float ldv(const float* p) { return *p; }
__device__ __forceinline__ float ldv(const bf16_t* p) { return __bfloat162float(*p); }
__device__ __forceinline__ float ldcgv(const float* p) { return __ldcg(p); }
__device__ __forceinline__ float ldcgv(const bf16_t* p) { return __bfloat162float(__ldcg(p)); }
__device__ __forceinline__ float ldgv(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ldgv(const bf16_t* p) { return __bfloat162float(__ldg(p)); }
__device__ __forceinline__ void stv(float* p, float v) { *p = v; }
__device__ __forceinline__ void stv(bf16_t* p, float v) { *p = __float2bfloat16_rn(v); }
template <typename S>
__device__ __forceinline__ float rnd(float v) {
  return v;
}
template <>
__device__ __forceinline__ float rnd<bf16_t>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
// four consecutive values from an aligned address (16 bytes of float, 8 of
// bf16)
__device__ __forceinline__ float4 bf4(uint2 u) {
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}
__device__ __forceinline__ float4 ldg4(const bf16_t* p) {
  return bf4(__ldg(reinterpret_cast<const uint2*>(p)));
}
// element i of the four-value groups from p (the float4 index form)
__device__ __forceinline__ float4 ld4i(const float* p, size_t i) {
  return reinterpret_cast<const float4*>(p)[i];
}
__device__ __forceinline__ float4 ld4i(const bf16_t* p, size_t i) {
  return bf4(reinterpret_cast<const uint2*>(p)[i]);
}
__device__ __forceinline__ float4 ldg4i(const float* p, size_t i) {
  return __ldg(reinterpret_cast<const float4*>(p) + i);
}
__device__ __forceinline__ float4 ldg4i(const bf16_t* p, size_t i) {
  return bf4(__ldg(reinterpret_cast<const uint2*>(p) + i));
}
__device__ __forceinline__ void st4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }
__device__ __forceinline__ void st4(bf16_t* p, float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y), hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<const unsigned*>(&lo);
  u.y = *reinterpret_cast<const unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}
// a weight group as loaded (float4, or the bf16 bits in a uint2, so the
// bf16 instantiations keep their loads in flight at half the registers)
// and its widening to float4
template <typename W>
struct Raw4 {
  typedef float4 type;
};
template <>
struct Raw4<bf16_t> {
  typedef uint2 type;
};
__device__ __forceinline__ float4 wide4(float4 v) { return v; }
__device__ __forceinline__ float4 wide4(uint2 u) { return bf4(u); }
__device__ __forceinline__ float4 raw4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ uint2 raw4(const bf16_t* p) {
  return *reinterpret_cast<const uint2*>(p);
}
__device__ __forceinline__ float4 rawg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ uint2 rawg4(const bf16_t* p) {
  return __ldg(reinterpret_cast<const uint2*>(p));
}
template <typename W>
__device__ __forceinline__ typename Raw4<W>::type zero4() {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}
template <>
__device__ __forceinline__ uint2 zero4<bf16_t>() {
  return make_uint2(0u, 0u);
}
template <typename S>
__device__ __forceinline__ float4 rnd4(float4 v) {
  return make_float4(rnd<S>(v.x), rnd<S>(v.y), rnd<S>(v.z), rnd<S>(v.w));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float sigm(float x) { return 1.f / (1.f + expf(-x)); }

__device__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
  for (int w = 0; w < WARPS; ++w) s += red[w];
  __syncthreads();
  return s;
}

// A staged input segment: rows p + b * ld, w floats each (w, ld multiples of 4).
struct Seg {
  const float* p;
  int ld, w;
};

// Rows [b0, b0 + nb) of the segments side by side into X (row stride xs),
// read through L2: other blocks wrote them during this launch.
__device__ void stage_rows(float* X, int xs, int b0, int nb, const Seg* segs, int nseg) {
  int off = 0;
  for (int s = 0; s < nseg; ++s) {
    const int w4 = segs[s].w >> 2;
    for (int e = threadIdx.x; e < nb * w4; e += THREADS) {
      const int b = e / w4, k = e - b * w4;
      const float4 v = __ldcg(reinterpret_cast<const float4*>(
                                  segs[s].p + (size_t)(b0 + b) * segs[s].ld) + k);
      reinterpret_cast<float4*>(X + (size_t)b * xs + off)[k] = v;
    }
    off += segs[s].w;
  }
}

template <int NG>
__device__ __forceinline__ void zero(float (&acc)[NG][RB]) {
#pragma unroll
  for (int g = 0; g < NG; ++g)
#pragma unroll
    for (int i = 0; i < RB; ++i) acc[g][i] = 0.f;
}

template <int NG>
__device__ __forceinline__ void reduce(float (&acc)[NG][RB]) {
#pragma unroll
  for (int g = 0; g < NG; ++g)
#pragma unroll
    for (int i = 0; i < RB; ++i) acc[g][i] = warp_sum(acc[g][i]);
}

// acc[g][i] += sum_k w[(g * gstride + j) * n + k] * X[i * xs + xoff + k] for
// the first nr staged rows: lanes along k, 16-byte loads.
template <int NG>
__device__ __forceinline__ void dots(float (&acc)[NG][RB], const float* __restrict__ w, int j,
                                     int gstride, int n, const float* X, int xs, int xoff,
                                     int nr) {
  const int lane = threadIdx.x & 31;
  for (int k = lane * 4; k < n; k += 128) {
    float4 xv[RB];
#pragma unroll
    for (int i = 0; i < RB; ++i)
      xv[i] = i < nr ? *reinterpret_cast<const float4*>(X + (size_t)i * xs + xoff + k)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      const float4 wv = __ldg(reinterpret_cast<const float4*>(
          w + ((size_t)g * gstride + j) * n + k));
#pragma unroll
      for (int i = 0; i < RB; ++i) {
        acc[g][i] = fmaf(wv.x, xv[i].x, acc[g][i]);
        acc[g][i] = fmaf(wv.y, xv[i].y, acc[g][i]);
        acc[g][i] = fmaf(wv.z, xv[i].z, acc[g][i]);
        acc[g][i] = fmaf(wv.w, xv[i].w, acc[g][i]);
      }
    }
  }
}

__device__ __forceinline__ float pick(const float (&a)[RB], int i) {
  float v = 0.f;
#pragma unroll
  for (int q = 0; q < RB; ++q)
    if (q == i) v = a[q];
  return v;
}

// A stage over `units` output units: every block with work stages the
// segments' rows (bc at a time), then each warp takes units and runs
// body(j, staged rows, first batch row, rows) over passes of RB rows.
template <typename Body>
__device__ void unit_stage(float* X, int B, int bc, int units, const Seg* segs, int nseg,
                           Body&& body) {
  if ((int)blockIdx.x >= units) return;  // block-uniform: no warp of it has a unit
  int xs = 0;
  for (int s = 0; s < nseg; ++s) xs += segs[s].w;
  const int warp = threadIdx.x >> 5;
  const int gw = warp * gridDim.x + blockIdx.x, nw = WARPS * gridDim.x;
  for (int c0 = 0; c0 < B; c0 += bc) {
    const int nb = min(bc, B - c0);
    __syncthreads();
    stage_rows(X, xs, c0, nb, segs, nseg);
    __syncthreads();
    for (int j = gw; j < units; j += nw)
      for (int r0 = 0; r0 < nb; r0 += RB)
        body(j, X + (size_t)r0 * xs, xs, c0 + r0, min(RB, nb - r0));
  }
}

// out[i] = add[i] + sum_k W[i * n + k] x[k] for i < rows (x in shared
// memory, n a multiple of 4): each warp takes 8 rows at a time, lanes along
// k with 16-byte loads, so 8 independent weight loads are in flight. `add`
// is read through L2 (another block may have written it in this launch);
// nullptr adds nothing.
__device__ void rows_matvec(const float* __restrict__ W, int rows, int n, const float* x,
                            const float* add, float* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i0 = warp * 8; i0 < rows; i0 += WARPS * 8) {
    float acc[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] = 0.f;
    for (int k = lane * 4; k < n; k += 128) {
      const float4 xv = *reinterpret_cast<const float4*>(x + k);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if (i0 + i < rows) {
          const float4 wv = __ldg(reinterpret_cast<const float4*>(W + (size_t)(i0 + i) * n + k));
          acc[i] = fmaf(wv.x, xv.x, acc[i]);
          acc[i] = fmaf(wv.y, xv.y, acc[i]);
          acc[i] = fmaf(wv.z, xv.z, acc[i]);
          acc[i] = fmaf(wv.w, xv.w, acc[i]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float s = warp_sum(acc[i]);
      if (lane == 0 && i0 + i < rows) out[i0 + i] = (add ? __ldcg(add + i0 + i) : 0.f) + s;
    }
  }
}

// out[e] = sum_t s[t] rows[t * E + e] (s in shared memory, E a multiple of
// 4): threads over float4 columns, the block's spare threads splitting the
// positions into slices whose partials are summed in a fixed order through
// red4 (red4_floats(E) floats). Written to out and, when given, out2.
__device__ void weighted_rows(const float* __restrict__ rows, int T, int E, const float* s,
                              float4* red4, float* out, float* out2) {
  const int E4 = E >> 2;
  for (int c0 = 0; c0 < E4; c0 += THREADS) {
    const int cols = min(E4 - c0, THREADS), ns = THREADS / cols;
    const int c = threadIdx.x % cols, sl = threadIdx.x / cols;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    if (sl < ns) {
#pragma unroll 4
      for (int t = sl; t < T; t += ns) {
        const float st = s[t];
        const float4 v = __ldg(reinterpret_cast<const float4*>(rows + (size_t)t * E) + c0 + c);
        acc.x = fmaf(st, v.x, acc.x);
        acc.y = fmaf(st, v.y, acc.y);
        acc.z = fmaf(st, v.z, acc.z);
        acc.w = fmaf(st, v.w, acc.w);
      }
    }
    __syncthreads();
    red4[threadIdx.x] = acc;
    __syncthreads();
    if (threadIdx.x < cols) {
      float4 sum = red4[threadIdx.x];
      for (int q = 1; q < ns; ++q) {
        const float4 p = red4[q * cols + threadIdx.x];
        sum.x += p.x;
        sum.y += p.y;
        sum.z += p.z;
        sum.w += p.w;
      }
      reinterpret_cast<float4*>(out)[c0 + threadIdx.x] = sum;
      if (out2) reinterpret_cast<float4*>(out2)[c0 + threadIdx.x] = sum;
    }
  }
  __syncthreads();
}

// arg[tt] = tanh((loc + encp) + q) of unit d at positions t0 + tt (0 where
// t0 + tt >= t0 + tc): the location conv composed with L from register
// windows of the cumulative and attention. The forward and the backward's
// recomputation run this same code.
template <typename W, typename SE>
__device__ __forceinline__ void lsa_args(float (&arg)[TC], int t0, int tc, int d, int D,
                                         float qd, const float* cumw, const float* attw,
                                         const W* w01t, const SE* encp_b) {
#pragma unroll
  for (int h = 0; h < TC / TH; ++h) {
    const int tb = t0 + h * TH;
    float cw[TH + CONV_K - 1], aw[TH + CONV_K - 1], loc[TH];
#pragma unroll
    for (int i = 0; i < TH + CONV_K - 1; ++i) {
      cw[i] = cumw[tb + i];
      aw[i] = attw[tb + i];
    }
#pragma unroll
    for (int j = 0; j < TH; ++j) loc[j] = 0.f;
#pragma unroll
    for (int k = 0; k < CONV_K; ++k) {
      const float w0 = ldv(w01t + (k * D + d)), w1 = ldv(w01t + ((CONV_K + k) * D + d));
#pragma unroll
      for (int j = 0; j < TH; ++j) {
        loc[j] = fmaf(w0, cw[j + k], loc[j]);
        loc[j] = fmaf(w1, aw[j + k], loc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < TH; ++j)
      arg[h * TH + j] = tb + j < t0 + tc
                            ? tanhf((loc[j] + ldv(encp_b + ((size_t)(tb + j) * D + d))) + qd) : 0.f;
  }
}

// u[tt] = sum_d v[d] arg[tt] over the block's units: a warp sum per
// position, then the warps' partials (red16, WARPS x TC) in a fixed order
// into u (TC floats, shared). Every thread of the block calls it.
__device__ void lsa_u(const float (&arg)[TC], float vd, float* red16, float* u) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int tt = 0; tt < TC; ++tt) {
    const float p = warp_sum(vd * arg[tt]);
    if (lane == 0) red16[warp * TC + tt] = p;
  }
  __syncthreads();
  if (threadIdx.x < TC) {
    float acc = 0.f;
    for (int w = 0; w < WARPS; ++w) acc += red16[w * TC + threadIdx.x];
    u[threadIdx.x] = acc;
  }
  __syncthreads();
}

// The location conv's input cotangent of one chunk, summed over the units:
// acc[j - 15] += sum_d sum_k dp[tt] w[k][d] for j = tt + k (j < TC + 30,
// positions t0 - 15 + j), w the cumulative's or the attention's taps (62 x D
// rows k0..k0+30). red: WARPS x (TC + 30) shared partials.
__device__ void loc_input_grad(const float (&dp)[TC], int d, bool unit, int D,
                               const float* w01t, int k0, float* red, float* acc) {
  constexpr int J = TC + CONV_K - 1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float c[J];
#pragma unroll
  for (int j = 0; j < J; ++j) c[j] = 0.f;
  if (unit) {
#pragma unroll
    for (int k = 0; k < CONV_K; ++k) {
      const float w = w01t[(k0 + k) * D + d];
#pragma unroll
      for (int tt = 0; tt < TC; ++tt) c[tt + k] = fmaf(dp[tt], w, c[tt + k]);
    }
  }
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const float p = warp_sum(c[j]);
    if (lane == 0) red[warp * J + j] = p;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < J; j += THREADS) {
    float s = 0.f;
    for (int w = 0; w < WARPS; ++w) s += red[w * J + j];
    acc[j] += s;
  }
  __syncthreads();
}

}  // namespace

namespace {

// AF: the prenet of group g, one block per utterance (see the header):
// prev, p1 and pre of every utterance into their streams.
__device__ void af_prenet(const AfFwdArgs& x, const float* wm_last, const float* x2, int g,
                          int B, int L, int P2, float* sm) {
  const int P1 = (int)x.P1, NM = (int)x.NM;
  for (int b = blockIdx.x; b < B; b += gridDim.x) {
    float* s_x = sm;
    float* s_pv = s_x + up4(L);
    float* s_p1 = s_pv + up4(NM);
    float* s_p2 = s_p1 + up4(P1);
    const size_t gbb = (size_t)g * B + b;
    __syncthreads();
    if (g > 0) {
      for (int e = threadIdx.x; e < L; e += THREADS) s_x[e] = __ldcg(x2 + (size_t)b * L + e);
      __syncthreads();
      rows_matvec(wm_last, NM, L, s_x, nullptr, s_pv);
    } else {
      for (int e = threadIdx.x; e < NM; e += THREADS) s_pv[e] = 0.f;
    }
    __syncthreads();
    for (int e = threadIdx.x; e < NM; e += THREADS) x.s_prev[gbb * NM + e] = s_pv[e];
    rows_matvec(x.w1, P1, NM, s_pv, x.b1, s_p1);
    __syncthreads();
    for (int k = threadIdx.x; k < P1; k += THREADS) {
      const float v = fmaxf(s_p1[k], 0.f) * x.dm1[gbb * P1 + k];
      s_p1[k] = v;
      x.s_p1[gbb * P1 + k] = v;
    }
    __syncthreads();
    rows_matvec(x.w2, P2, P1, s_p1, x.b2, s_p2);
    __syncthreads();
    for (int j = threadIdx.x; j < P2; j += THREADS)
      x.s_pre[gbb * P2 + j] = fmaxf(s_p2[j], 0.f) * x.dm2[gbb * P2 + j];
  }
}

template <bool AF>
__device__ __forceinline__ void fwd_body(const TfFwdArgs& a, const AfFwdArgs& x) {
  cg::grid_group grid = cg::this_grid();
  const int G = (int)a.G, B = (int)a.B, T = (int)a.T, E = (int)a.E, D = (int)a.D;
  const int P2 = (int)a.P2, L = (int)a.L, F = (int)a.F, bc = (int)a.bc;
  const bool save = a.save != 0;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  FwdWork wk(a.work, a);

  extern __shared__ float smem[];
  float* s_w01t = smem;                    // (62, D) for the whole launch
  float* sm = s_w01t + NTAP * D;           // staged rows, or attention scratch
  for (int e = threadIdx.x; e < NTAP * D; e += THREADS) s_w01t[e] = a.w01t[e];

  // mel_proj of group g: x2 @ wm^T
  auto mel_stage = [&](int g) {
    const Seg segs[1] = {{wk.x2, L, L}};
    unit_stage(sm, B, bc, F, segs, 1,
               [&](int f, const float* X, int xs, int b0, int nr) {
                 float acc[1][RB];
                 zero(acc);
                 dots<1>(acc, a.wm, f, 0, L, X, xs, 0, nr);
                 reduce(acc);
                 if (lane < nr) a.mel[((size_t)g * B + b0 + lane) * F + f] = pick(acc[0], lane);
               });
  };

  int cur = 0;
  for (int g = 0; g < G; ++g) {
    const int nxt = cur ^ 1;
    const size_t gb = (size_t)g * B;
    if constexpr (AF) {
      // ---- P: the prenet on the previous group's last frame ----
      af_prenet(x, a.wm + (size_t)(F - x.NM) * L, wk.x2, g, B, L, P2, sm);
      grid.sync();
    }
    // ---- A: attention GRUCell on [ctx | pre_g], h = ah ----
    {
      const Seg segs[3] = {{wk.ctx[cur], E, E}, {a.pre + gb * P2, P2, P2}, {wk.ah[cur], D, D}};
      unit_stage(sm, B, bc, D, segs, 3,
                 [&](int j, const float* X, int xs, int b0, int nr) {
                   float gi[3][RB], gh[3][RB];
                   zero(gi);
                   zero(gh);
                   dots<3>(gi, a.awi, j, D, E + P2, X, xs, 0, nr);
                   dots<3>(gh, a.awh, j, D, D, X, xs, E + P2, nr);
                   reduce(gi);
                   reduce(gh);
                   if (lane < nr) {
                     const int b = b0 + lane;
                     const float r = sigm((pick(gi[0], lane) + a.abi[j]) +
                                          (pick(gh[0], lane) + a.abh[j]));
                     const float z = sigm((pick(gi[1], lane) + a.abi[D + j]) +
                                          (pick(gh[1], lane) + a.abh[D + j]));
                     const float hn = pick(gh[2], lane) + a.abh[2 * D + j];
                     const float n = tanhf((pick(gi[2], lane) + a.abi[2 * D + j]) + r * hn);
                     const float hp = X[(size_t)lane * xs + E + P2 + j];
                     const float h = (1.f - z) * n + z * hp;
                     wk.ah[nxt][(size_t)b * D + j] = h;
                     if (save) {
                       a.s_ah[(gb + b) * D + j] = h;
                       float* s = a.s_gru + (gb + b) * 4 * D;
                       s[j] = r;
                       s[D + j] = z;
                       s[2 * D + j] = n;
                       s[3 * D + j] = hn;
                     }
                   }
                 });
    }
    if (g > 0) mel_stage(g - 1);
    grid.sync();
    // ---- B: location-sensitive attention, one block per utterance ----
    for (int b = blockIdx.x; b < B; b += gridDim.x) {
      float* s_v = sm;
      float* s_ah = s_v + up4(D);
      float* s_q = s_ah + up4(D);
      float* cumw = s_q + up4(D);
      float* attw = cumw + win_floats(T);
      float* s_sig = attw + win_floats(T);
      float* red16 = s_sig + up4(T);
      float* s_u = red16 + WARPS * TC;
      float* red = s_u + TC;
      float4* red4 = reinterpret_cast<float4*>(red + WARPS);
      __syncthreads();
      for (int e = threadIdx.x; e < D; e += THREADS) {
        s_v[e] = a.v[e];
        s_ah[e] = __ldcg(wk.ah[nxt] + (size_t)b * D + e);
      }
      for (int e = threadIdx.x; e < win_floats(T); e += THREADS) {
        const int t = e - CONV_HALF;
        const bool in = t >= 0 && t < T;
        cumw[e] = in ? __ldcg(wk.cum[cur] + (size_t)b * T + t) : 0.f;
        attw[e] = in ? __ldcg(wk.att[cur] + (size_t)b * T + t) : 0.f;
      }
      __syncthreads();
      rows_matvec(a.wq, D, D, s_ah, a.qb, s_q);
      __syncthreads();
      const float* encp_b = a.encp + (size_t)b * T * D;
      const int d = threadIdx.x;
      const bool unit = d < D;
      const float qd = unit ? s_q[d] : 0.f, vd = unit ? s_v[d] : 0.f;
      for (int t0 = 0; t0 < T; t0 += TC) {
        const int tc = min(TC, T - t0);
        float arg[TC];
        if (unit) {
          lsa_args(arg, t0, tc, d, D, qd, cumw, attw, s_w01t, encp_b);
        } else {
#pragma unroll
          for (int tt = 0; tt < TC; ++tt) arg[tt] = 0.f;
        }
        lsa_u(arg, vd, red16, s_u);
        if (threadIdx.x < tc) s_sig[t0 + threadIdx.x] = sigm(s_u[threadIdx.x]);
      }
      __syncthreads();
      float part = 0.f;
      for (int t = threadIdx.x; t < T; t += THREADS) part += s_sig[t];
      const float div = block_sum(part, red);
      const float dv = div > 0.f ? div : 1.f;
      for (int t = threadIdx.x; t < T; t += THREADS) {
        const float sc = s_sig[t] / dv;
        s_sig[t] = sc;
        const size_t o = (gb + b) * T + t;
        a.scores[o] = sc;
        wk.att[nxt][(size_t)b * T + t] = sc;
        wk.cum[nxt][(size_t)b * T + t] = cumw[t + CONV_HALF] + sc;
        if (save) a.s_cum[o] = cumw[t + CONV_HALF];
      }
      __syncthreads();
      if constexpr (AF) {   // the context weights: the reference attention
        for (int t = threadIdx.x; t < T; t += THREADS) s_sig[t] = x.aref[(gb + b) * T + t];
        __syncthreads();
      }
      weighted_rows(a.enc + (size_t)b * T * E, T, E, s_sig, red4,
                    wk.ctx[nxt] + (size_t)b * E, save ? a.s_ctx + (gb + b) * E : nullptr);
      if (save) {
        for (int d = threadIdx.x; d < D; d += THREADS) a.s_q[(gb + b) * D + d] = s_q[d];
        if (threadIdx.x == 0) a.s_div[gb + b] = div;
      }
    }
    grid.sync();
    // ---- C: rnn_input on [ctx | ah] ----
    {
      const Seg segs[2] = {{wk.ctx[nxt], E, E}, {wk.ah[nxt], D, D}};
      unit_stage(sm, B, bc, L, segs, 2,
                 [&](int j, const float* X, int xs, int b0, int nr) {
                   float acc[1][RB];
                   zero(acc);
                   dots<1>(acc, a.wr, j, 0, E + D, X, xs, 0, nr);
                   reduce(acc);
                   if (lane < nr) {
                     const int b = b0 + lane;
                     const float x0 = pick(acc[0], lane) + a.br[j];
                     wk.x0[(size_t)b * L + j] = x0;
                     if (save) a.s_x0[(gb + b) * L + j] = x0;
                   }
                 });
    }
    grid.sync();
    // ---- D, E: the residual LSTMCells with zoneout on h ----
    for (int layer = 0; layer < 2; ++layer) {
      const float* wi = layer == 0 ? a.l1wi : a.l2wi;
      const float* wh = layer == 0 ? a.l1wh : a.l2wh;
      const float* bias = layer == 0 ? a.l1b : a.l2b;
      const float* zm = (layer == 0 ? a.zm1 : a.zm2) + gb * L;
      const float* xin = layer == 0 ? wk.x0 : wk.x1;
      float* xout = layer == 0 ? wk.x1 : wk.x2;
      const float* h_cur = layer == 0 ? wk.h1[cur] : wk.h2[cur];
      const float* c_cur = layer == 0 ? wk.c1[cur] : wk.c2[cur];
      float* h_nxt = layer == 0 ? wk.h1[nxt] : wk.h2[nxt];
      float* c_nxt = layer == 0 ? wk.c1[nxt] : wk.c2[nxt];
      float* s_gates = layer == 0 ? a.s_g1 : a.s_g2;
      float* s_c = layer == 0 ? a.s_c1 : a.s_c2;
      float* s_h = layer == 0 ? a.s_h1 : a.s_h2;
      float* s_x = layer == 0 ? a.s_x1 : a.s_x2;
      const Seg segs[2] = {{xin, L, L}, {h_cur, L, L}};
      unit_stage(sm, B, bc, L, segs, 2,
                 [&](int j, const float* X, int xs, int b0, int nr) {
                   float acc[4][RB];
                   zero(acc);
                   dots<4>(acc, wi, j, L, L, X, xs, 0, nr);
                   dots<4>(acc, wh, j, L, L, X, xs, L, nr);
                   reduce(acc);
                   if (lane < nr) {
                     const int b = b0 + lane;
                     const size_t o = (size_t)b * L + j;
                     const float ig = sigm(pick(acc[0], lane) + bias[j]);
                     const float fg = sigm(pick(acc[1], lane) + bias[L + j]);
                     const float gg = tanhf(pick(acc[2], lane) + bias[2 * L + j]);
                     const float og = sigm(pick(acc[3], lane) + bias[3 * L + j]);
                     const float c = fg * __ldcg(c_cur + o) + ig * gg;
                     const float hp = X[(size_t)lane * xs + L + j];
                     const float zz = zm[o];
                     const float h = zz * hp + (1.f - zz) * (og * tanhf(c));
                     const float x = X[(size_t)lane * xs + j] + h;
                     c_nxt[o] = c;
                     h_nxt[o] = h;
                     xout[o] = x;
                     if (save) {
                       const size_t so = (gb + b) * L + j;
                       float* sg = s_gates + (gb + b) * 4 * L;
                       sg[j] = ig;
                       sg[L + j] = fg;
                       sg[2 * L + j] = gg;
                       sg[3 * L + j] = og;
                       s_c[so] = c;
                       s_h[so] = h;
                       s_x[so] = x;
                     }
                   }
                 });
      grid.sync();
    }
    cur = nxt;
  }
  mel_stage(G - 1);
}

#ifndef TACO_TRAIN_HELPERS_ONLY   // taco_tf_resident.cu takes the helpers alone
__global__ void __launch_bounds__(THREADS, 1) taco_tf_fwd(TfFwdArgs a) {
  fwd_body<false>(a, AfFwdArgs{});
}

__global__ void __launch_bounds__(THREADS, 1) taco_af_fwd(TfFwdArgs a, AfFwdArgs x) {
  fwd_body<true>(a, x);
}
#endif

}  // namespace

namespace {

// LSTM cell backward of one (row, unit): from the cotangent of its h output
// (dh) and of its c carry (dc_in) to the pre-activation cotangents dG[4],
// the cotangent of c_prev, and z * dh (the zoneout part of dh_prev).
struct LstmBwd {
  float dg[4], dc_prev, wz;
};
template <typename S>
__device__ __forceinline__ LstmBwd lstm_bwd(float dh, float dc_in, const S* gates, int j,
                                            int L, float c, float c_prev, float z) {
  const float ig = ldv(gates + j), fg = ldv(gates + (L + j)), gg = ldv(gates + (2 * L + j)),
              og = ldv(gates + (3 * L + j));
  const float tc = tanhf(c);
  const float dht = (1.f - z) * dh;
  const float dcn = dc_in + dht * og * (1.f - tc * tc);
  LstmBwd r;
  r.dg[0] = dcn * gg * ig * (1.f - ig);
  r.dg[1] = dcn * c_prev * fg * (1.f - fg);
  r.dg[2] = dcn * ig * (1.f - gg * gg);
  r.dg[3] = dht * tc * og * (1.f - og);
  r.dc_prev = dcn * fg;
  r.wz = z * dh;
  return r;
}

template <bool AF>
__device__ __forceinline__ void bwd_body(const TfBwdArgs& a, const AfBwdArgs& x) {
  cg::grid_group grid = cg::this_grid();
  const int G = (int)a.G, B = (int)a.B, T = (int)a.T, E = (int)a.E, D = (int)a.D;
  const int P2 = (int)a.P2, L = (int)a.L, F = (int)a.F, bc = (int)a.bc;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  BwdWork wk(a.work, a);

  extern __shared__ float smem[];
  float* s_w01t = smem;
  float* sm = s_w01t + NTAP * D;
  for (int e = threadIdx.x; e < NTAP * D; e += THREADS) s_w01t[e] = a.w01t[e];

  for (int g = G - 1; g >= 0; --g) {
    const size_t gb = (size_t)g * B;
    // ---- 1: dx2 = dmel @ wm, then LSTM2's cell backward ----
    {
      const Seg segs[1] = {{a.dmel + gb * F, F, F}};
      unit_stage(sm, B, bc, L, segs, 1,
                 [&](int j, const float* X, int xs, int b0, int nr) {
                   float acc[1][RB];
                   zero(acc);
                   dots<1>(acc, a.wmT, j, 0, F, X, xs, 0, nr);
                   reduce(acc);
                   if (lane < nr) {
                     const int b = b0 + lane;
                     const size_t o = (size_t)b * L + j, so = (gb + b) * L + j;
                     const float dx2 = pick(acc[0], lane);
                     const float cp = g > 0 ? a.s_c2[so - (size_t)B * L] : 0.f;
                     const LstmBwd r = lstm_bwd(__ldcg(wk.dh2 + o) + dx2, __ldcg(wk.dc2 + o),
                                                a.s_g2 + (gb + b) * 4 * L, j, L, a.s_c2[so], cp,
                                                a.zm2[so]);
                     float* dg = a.c_dg2 + (gb + b) * 4 * L;
                     for (int q = 0; q < 4; ++q) dg[q * L + j] = r.dg[q];
                     wk.dc2[o] = r.dc_prev;
                     wk.wz2[o] = r.wz;
                     wk.dx2[o] = dx2;
                   }
                 });
    }
    grid.sync();
    // ---- 2: dx1 = dx2 + dG2 @ l2wi, dh2 = z dh + dG2 @ l2wh, LSTM1 ----
    {
      const Seg segs[1] = {{a.c_dg2 + gb * 4 * L, 4 * L, 4 * L}};
      unit_stage(sm, B, bc, L, segs, 1,
                 [&](int j, const float* X, int xs, int b0, int nr) {
                   float ai[1][RB], ah[1][RB];
                   zero(ai);
                   zero(ah);
                   dots<1>(ai, a.l2wiT, j, 0, 4 * L, X, xs, 0, nr);
                   dots<1>(ah, a.l2whT, j, 0, 4 * L, X, xs, 0, nr);
                   reduce(ai);
                   reduce(ah);
                   if (lane < nr) {
                     const int b = b0 + lane;
                     const size_t o = (size_t)b * L + j, so = (gb + b) * L + j;
                     const float dx1 = __ldcg(wk.dx2 + o) + pick(ai[0], lane);
                     wk.dh2[o] = __ldcg(wk.wz2 + o) + pick(ah[0], lane);
                     const float cp = g > 0 ? a.s_c1[so - (size_t)B * L] : 0.f;
                     const LstmBwd r = lstm_bwd(__ldcg(wk.dh1 + o) + dx1, __ldcg(wk.dc1 + o),
                                                a.s_g1 + (gb + b) * 4 * L, j, L, a.s_c1[so], cp,
                                                a.zm1[so]);
                     float* dg = a.c_dg1 + (gb + b) * 4 * L;
                     for (int q = 0; q < 4; ++q) dg[q * L + j] = r.dg[q];
                     wk.dc1[o] = r.dc_prev;
                     wk.wz1[o] = r.wz;
                     wk.dx1[o] = dx1;
                   }
                 });
    }
    grid.sync();
    // ---- 3: dx0 = dx1 + dG1 @ l1wi, dh1 = z dh + dG1 @ l1wh ----
    {
      const Seg segs[1] = {{a.c_dg1 + gb * 4 * L, 4 * L, 4 * L}};
      unit_stage(sm, B, bc, L, segs, 1,
                 [&](int j, const float* X, int xs, int b0, int nr) {
                   float ai[1][RB], ah[1][RB];
                   zero(ai);
                   zero(ah);
                   dots<1>(ai, a.l1wiT, j, 0, 4 * L, X, xs, 0, nr);
                   dots<1>(ah, a.l1whT, j, 0, 4 * L, X, xs, 0, nr);
                   reduce(ai);
                   reduce(ah);
                   if (lane < nr) {
                     const int b = b0 + lane;
                     const size_t o = (size_t)b * L + j;
                     a.c_dx0[(gb + b) * L + j] = __ldcg(wk.dx1 + o) + pick(ai[0], lane);
                     wk.dh1[o] = __ldcg(wk.wz1 + o) + pick(ah[0], lane);
                   }
                 });
    }
    grid.sync();
    // ---- 4: [dctx | dah] += dx0 @ wr ----
    {
      const Seg segs[1] = {{a.c_dx0 + gb * L, L, L}};
      unit_stage(sm, B, bc, E + D, segs, 1,
                 [&](int u, const float* X, int xs, int b0, int nr) {
                   float acc[1][RB];
                   zero(acc);
                   dots<1>(acc, a.wrT, u, 0, L, X, xs, 0, nr);
                   reduce(acc);
                   if (lane < nr) {
                     const int b = b0 + lane;
                     const float v = pick(acc[0], lane);
                     if (u < E)
                       wk.dctx_t[(size_t)b * E + u] = __ldcg(wk.dctx + (size_t)b * E + u) + v;
                     else
                       wk.dahp[(size_t)b * D + u - E] = __ldcg(wk.dah + (size_t)b * D + u - E) + v;
                   }
                 });
    }
    grid.sync();
    // ---- 5: attention backward and the GRU cell's, one block per utterance ----
    for (int b = blockIdx.x; b < B; b += gridDim.x) {
      float* s_v = sm;
      float* s_q = s_v + up4(D);
      float* s_dq = s_q + up4(D);
      float* s_dah = s_dq + up4(D);
      float* cumw = s_dah + up4(D);
      float* attw = cumw + win_floats(T);
      float* dcw = attw + win_floats(T);   // the conv's input cotangents,
      float* daw = dcw + win_floats(T);    // windowed like cumw / attw
      float* s_s = daw + win_floats(T);
      float* s_ds = s_s + up4(T);
      float* s_du = s_ds + up4(T);         // TC: the chunk's d(energy)
      float* s_dctx = s_du + TC;
      float* red16 = s_dctx + up4(E);
      float* s_u = red16 + WARPS * TC;
      float* red = s_u + TC;
      float* redj = red + WARPS;           // LOC_RED
      float* s_gw = redj + LOC_RED;        // this group's location-weight gradient (62, D)
      float* s_dgi = s_gw + NTAP * D;      // AF: the prenet chain (af_bwd_floats)
      const size_t gbb = gb + b;
      __syncthreads();
      for (int e = threadIdx.x; e < D; e += THREADS) {
        s_v[e] = a.v[e];
        s_q[e] = a.s_q[gbb * D + e];
      }
      for (int e = threadIdx.x; e < NTAP * D; e += THREADS) s_gw[e] = 0.f;
      for (int e = threadIdx.x; e < win_floats(T); e += THREADS) {
        const int t = e - CONV_HALF;
        const bool in = t >= 0 && t < T;
        cumw[e] = in ? a.s_cum[gbb * T + t] : 0.f;
        attw[e] = in && g > 0 ? a.scores[(gbb - B) * T + t] : 0.f;
        dcw[e] = 0.f;
        daw[e] = 0.f;
      }
      for (int t = threadIdx.x; t < T; t += THREADS) s_s[t] = a.scores[gbb * T + t];
      for (int e = threadIdx.x; e < E; e += THREADS)
        s_dctx[e] = __ldcg(wk.dctx_t + (size_t)b * E + e);
      __syncthreads();
      // ds = d(scores) + d(cumulative) + d(attention) + dctx . enc_t, and
      // d(enc_t) += s_t dctx; each lane's loads go out before its stores.
      // AF: the context weights are aref, and dctx . enc_t is d(aref)
      const float* enc_b = a.enc + (size_t)b * T * E;
      float* denc_b = a.denc + (size_t)b * T * E;
      for (int t = warp; t < T; t += WARPS) {
        float acc = 0.f;
        const float st = AF ? x.aref[gbb * T + t] : s_s[t];
        for (int e0 = 0; e0 < E; e0 += 32 * 8) {
          float ev[8], dv[8];
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int e = e0 + lane + 32 * i;
            if (e < E) {
              ev[i] = enc_b[(size_t)t * E + e];
              dv[i] = __ldcg(denc_b + (size_t)t * E + e);
            }
          }
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int e = e0 + lane + 32 * i;
            if (e < E) {
              acc = fmaf(s_dctx[e], ev[i], acc);
              denc_b[(size_t)t * E + e] = dv[i] + st * s_dctx[e];
            }
          }
        }
        acc = warp_sum(acc);
        if (lane == 0) {
          const float ds = a.dsc[gbb * T + t] + __ldcg(wk.dcum + (size_t)b * T + t) +
                           __ldcg(wk.datt + (size_t)b * T + t);
          if constexpr (AF) {
            s_ds[t] = ds;
            x.daref[gbb * T + t] = acc;
          } else {
            s_ds[t] = ds + acc;
          }
        }
      }
      __syncthreads();
      float part = 0.f;
      for (int t = threadIdx.x; t < T; t += THREADS) part += s_ds[t] * s_s[t];
      const float S = block_sum(part, red);
      const float div = a.s_div[gbb];
      const float* encp_b = a.encp + (size_t)b * T * D;
      float* dencp_b = a.dencp + (size_t)b * T * D;
      const int d = threadIdx.x;
      const bool unit = d < D;
      const float qd = unit ? s_q[d] : 0.f, vd = unit ? s_v[d] : 0.f;
      float dv_d = 0.f, dq_d = 0.f;
      for (int t0 = 0; t0 < T; t0 += TC) {
        const int tc = min(TC, T - t0);
        float arg[TC], dp[TC];
        if (unit) {
          lsa_args(arg, t0, tc, d, D, qd, cumw, attw, s_w01t, encp_b);
        } else {
#pragma unroll
          for (int tt = 0; tt < TC; ++tt) arg[tt] = 0.f;
        }
        lsa_u(arg, vd, red16, s_u);
        if (threadIdx.x < tc) {
          const int t = t0 + threadIdx.x;
          const float sig = sigm(s_u[threadIdx.x]);
          const float dsig = div > 0.f ? (s_ds[t] - S) / div : s_ds[t];
          s_du[threadIdx.x] = dsig * sig * (1.f - sig);
        }
        __syncthreads();
        // d(tanh argument) of unit d; dv, dq and d(encp) along the way, the
        // loads of d(encp) issued before its stores
#pragma unroll
        for (int tt = 0; tt < TC; ++tt) dp[tt] = 0.f;
        if (unit) {
          float old[TC];
#pragma unroll
          for (int tt = 0; tt < TC; ++tt)
            if (tt < tc) old[tt] = __ldcg(dencp_b + (size_t)(t0 + tt) * D + d);
#pragma unroll
          for (int tt = 0; tt < TC; ++tt) {
            if (tt < tc) {
              const float ar = arg[tt], du = s_du[tt];
              dp[tt] = du * vd * (1.f - ar * ar);
              dv_d = fmaf(du, ar, dv_d);
              dq_d += dp[tt];
              dencp_b[(size_t)(t0 + tt) * D + d] = old[tt] + dp[tt];
            }
          }
          // the location weight's gradient, column d (this thread's own)
#pragma unroll 1
          for (int k = 0; k < CONV_K; ++k) {
            float gc = 0.f, ga = 0.f;
#pragma unroll
            for (int tt = 0; tt < TC; ++tt) {
              gc = fmaf(dp[tt], cumw[t0 + tt + k], gc);
              ga = fmaf(dp[tt], attw[t0 + tt + k], ga);
            }
            s_gw[k * D + d] += gc;
            s_gw[(CONV_K + k) * D + d] += ga;
          }
        }
        // the location conv's input cotangents, cumulative then attention
        loc_input_grad(dp, d, unit, D, s_w01t, 0, redj, dcw + t0);
        loc_input_grad(dp, d, unit, D, s_w01t, CONV_K, redj, daw + t0);
      }
      // the group's location-weight and v gradients into the utterance's
      // partials, eight loads in flight before their stores
      float* pw = a.pw01 + (size_t)b * NTAP * D;
      for (int i0 = threadIdx.x; i0 < NTAP * D; i0 += THREADS * 8) {
        float old[8];
#pragma unroll
        for (int q = 0; q < 8; ++q)
          if (i0 + q * THREADS < NTAP * D) old[q] = __ldcg(pw + i0 + q * THREADS);
#pragma unroll
        for (int q = 0; q < 8; ++q)
          if (i0 + q * THREADS < NTAP * D) pw[i0 + q * THREADS] = old[q] + s_gw[i0 + q * THREADS];
      }
      if (unit) {
        a.pv[(size_t)b * D + d] = __ldcg(a.pv + (size_t)b * D + d) + dv_d;
        s_dq[d] = dq_d;
        a.c_dq[gbb * D + d] = dq_d;
      }
      // carries into group g-1: d(cumulative) passes through and gathers the
      // conv's taps; d(attention) is the conv's alone
      for (int t = threadIdx.x; t < T; t += THREADS) {
        float* dc = wk.dcum + (size_t)b * T + t;
        *dc = __ldcg(dc) + dcw[t + CONV_HALF];
        wk.datt[(size_t)b * T + t] = daw[t + CONV_HALF];
      }
      __syncthreads();
      // dah = dahp + dq @ wq
      rows_matvec(a.wqT, D, D, s_dq, wk.dahp + (size_t)b * D, s_dah);
      __syncthreads();
      // the attention GRUCell's backward (elementwise per unit)
      const float* sg = a.s_gru + gbb * 4 * D;
      for (int j = threadIdx.x; j < D; j += THREADS) {
        const float dh = s_dah[j];
        const float r = sg[j], z = sg[D + j], n = sg[2 * D + j], hn = sg[3 * D + j];
        const float hp = g > 0 ? a.s_ah[(gbb - B) * D + j] : 0.f;
        const float dz = dh * (hp - n);
        const float dn = dh * (1.f - z);
        const float dpre_n = dn * (1.f - n * n);
        const float dpre_r = (dpre_n * hn) * r * (1.f - r);
        const float dpre_z = dz * z * (1.f - z);
        float* gi = a.c_dgi + gbb * 3 * D;
        float* gh = a.c_dgh + gbb * 3 * D;
        gi[j] = dpre_r;
        gi[D + j] = dpre_z;
        gi[2 * D + j] = dpre_n;
        gh[j] = dpre_r;
        gh[D + j] = dpre_z;
        gh[2 * D + j] = dpre_n * r;
        wk.dtz[(size_t)b * D + j] = dh * z;
        if constexpr (AF) {
          s_dgi[j] = dpre_r;
          s_dgi[D + j] = dpre_z;
          s_dgi[2 * D + j] = dpre_n;
        }
      }
      if constexpr (AF) {
        // the prenet's backward: dpre = dgi @ awi[:, E:], then through
        // the second and first layers (ReLU and the dropout keep-masks)
        // to d(prev), which joins the last frame of group g-1's dmel
        const int P1 = (int)x.P1, NM = (int)x.NM;
        float* s_d2 = s_dgi + up4(3 * D);
        float* s_d1 = s_d2 + up4(P2);
        float* s_d0 = s_d1 + up4(P1);
        __syncthreads();
        rows_matvec(a.awiT + (size_t)E * 3 * D, P2, 3 * D, s_dgi, nullptr, s_d2);
        __syncthreads();
        for (int j = threadIdx.x; j < P2; j += THREADS) {
          const size_t o = gbb * P2 + j;
          const float v = a.pre[o] > 0.f ? s_d2[j] * x.dm2[o] : 0.f;
          s_d2[j] = v;
          x.c_dp2[o] = v;
        }
        __syncthreads();
        rows_matvec(x.w2T, P1, P2, s_d2, nullptr, s_d1);
        __syncthreads();
        for (int k = threadIdx.x; k < P1; k += THREADS) {
          const size_t o = gbb * P1 + k;
          const float v = x.s_p1[o] > 0.f ? s_d1[k] * x.dm1[o] : 0.f;
          s_d1[k] = v;
          x.c_dp1[o] = v;
        }
        __syncthreads();
        if (g > 0) {
          rows_matvec(x.w1T, NM, P1, s_d1, nullptr, s_d0);
          __syncthreads();
          float* dm = x.dmel + (gbb - B) * F + F - NM;
          for (int m = threadIdx.x; m < NM; m += THREADS) dm[m] = __ldcg(dm + m) + s_d0[m];
        }
      }
    }
    grid.sync();
    // ---- 7: [dctx | dpre] = dgi @ awi, dah = dah z + dgh @ awh (AF: the
    // attention stage took dpre) ----
    {
      const int ni = AF ? E : E + P2;   // units from awi; the rest from awh
      const Seg segs[2] = {{a.c_dgi + gb * 3 * D, 3 * D, 3 * D},
                           {a.c_dgh + gb * 3 * D, 3 * D, 3 * D}};
      unit_stage(sm, B, bc, ni + D, segs, 2,
                 [&](int u, const float* X, int xs, int b0, int nr) {
                   float acc[1][RB];
                   zero(acc);
                   if (u < ni)
                     dots<1>(acc, a.awiT, u, 0, 3 * D, X, xs, 0, nr);
                   else
                     dots<1>(acc, a.awhT, u - ni, 0, 3 * D, X, xs, 3 * D, nr);
                   reduce(acc);
                   if (lane < nr) {
                     const int b = b0 + lane;
                     const float v = pick(acc[0], lane);
                     if (u < E) {
                       wk.dctx[(size_t)b * E + u] = v;
                     } else if (u < ni) {
                       a.dpre[(gb + b) * P2 + u - E] = v;
                     } else {
                       const size_t o = (size_t)b * D + u - ni;
                       wk.dah[o] = __ldcg(wk.dtz + o) + v;
                     }
                   }
                 });
    }
  }
}

#ifndef TACO_TRAIN_HELPERS_ONLY   // taco_tf_resident.cu takes the helpers alone
__global__ void __launch_bounds__(THREADS, 1) taco_tf_bwd(TfBwdArgs a) {
  bwd_body<false>(a, AfBwdArgs{});
}

__global__ void __launch_bounds__(THREADS, 1) taco_af_bwd(TfBwdArgs a, AfBwdArgs x) {
  bwd_body<true>(a, x);
}
#endif

// C (M x N, row stride ldc) = sum_r A[r, m] * Bm[r - shift, n] over r < R
// (rows r < shift of Bm are zero): 64 x 64 tiles, 16 rows of r per pass,
// each thread a 4 x 4 block; one thread per output, a fixed order.
template <typename SB>
__global__ void __launch_bounds__(256) wgrad_gemm(const float* __restrict__ A, int lda,
                                                  const SB* __restrict__ Bm, int ldb,
                                                  int shift, float* C, int ldc, int M, int N,
                                                  int R) {
  __shared__ float As[16][64];
  __shared__ float Bs[16][64];
  const int m0 = blockIdx.y * 64, n0 = blockIdx.x * 64;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float acc[4][4] = {};
  for (int r0 = 0; r0 < R; r0 += 16) {
    for (int e = threadIdx.x; e < 16 * 64; e += 256) {
      const int rr = e >> 6, cc = e & 63, r = r0 + rr;
      const int m = m0 + cc, n = n0 + cc, rb = r - shift;
      As[rr][cc] = (r < R && m < M) ? A[(size_t)r * lda + m] : 0.f;
      Bs[rr][cc] = (r < R && rb >= 0 && n < N) ? ldv(Bm + ((size_t)rb * ldb + n)) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = As[k][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Bs[k][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < N) C[(size_t)m * ldc + n] = acc[i][j];
    }
  }
}

// out[m] = sum_r A[r, m] over r < R (a bias gradient).
__global__ void colsum(const float* __restrict__ A, int lda, float* out, int M, int R) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= M) return;
  float s = 0.f;
  for (int r = 0; r < R; ++r) s += A[(size_t)r * lda + m];
  out[m] = s;
}

// out = sum over n_parts of the (rows, cols) partials P; transposed to
// (cols, rows) when `transpose`.
__global__ void reduce_parts(const float* __restrict__ P, int n_parts, int rows, int cols,
                             int transpose, float* out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rows * cols) return;
  float s = 0.f;
  for (int p = 0; p < n_parts; ++p) s += P[(size_t)p * rows * cols + i];
  const int r = i / cols, c = i - r * cols;
  out[transpose ? (size_t)c * rows + r : (size_t)i] = s;
}

}  // namespace

namespace {

// Batch rows staged per pass, and the dynamic shared bytes, for a stage row
// of `row` floats and `lsa` floats of attention scratch; 0 rows when even
// one row does not fit.
struct Plan {
  int bc;
  size_t smem;
};
Plan make_plan(int64_t B, int64_t D, int64_t row, int64_t lsa) {
  Plan p;
  if (D > THREADS) return Plan{0, 0};  // the attention stages: a thread per unit
  const int64_t room = SMEM_FLOATS - NTAP * D;
  int64_t bc = room / row;
  if (bc > B) bc = B;
  p.bc = (int)(bc < 0 ? 0 : bc);
  int64_t body = bc * row;
  if (lsa > body) body = lsa;
  p.smem = (size_t)(NTAP * D + body) * sizeof(float);
  return p;
}

cudaError_t launch_coop(const void* fn, size_t smem, void** kargs, cudaStream_t stream) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, THREADS, smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  e = cudaLaunchCooperativeKernel(fn, dim3(sms), dim3(THREADS), kargs, smem, stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <typename SB>
cudaError_t gemm(cudaStream_t st, const float* A, int64_t lda, const SB* Bm, int64_t ldb,
                 int64_t shift, float* C, int64_t ldc, int64_t M, int64_t N, int64_t R) {
  const dim3 grid((unsigned)((N + 63) / 64), (unsigned)((M + 63) / 64));
  wgrad_gemm<<<grid, 256, 0, st>>>(A, (int)lda, Bm, (int)ldb, (int)shift, C, (int)ldc,
                                   (int)M, (int)N, (int)R);
  return cudaGetLastError();
}

cudaError_t csum(cudaStream_t st, const float* A, int64_t lda, float* out, int64_t M,
                 int64_t R) {
  colsum<<<(unsigned)((M + 255) / 256), 256, 0, st>>>(A, (int)lda, out, (int)M, (int)R);
  return cudaGetLastError();
}

// Every weight gradient of the recurrence from the cotangent streams the
// backward launch wrote (the AF arm adds the prenet's).
cudaError_t wgrads(const TfBwdArgs& a, const AfBwdArgs* x, cudaStream_t st) {
  cudaError_t e;
  const int64_t R = a.G * a.B, B = a.B, D = a.D, E = a.E, P2 = a.P2, L = a.L, F = a.F;
  // attention GRUCell: input [ctx_prev | pre], hidden ah_prev (rows shifted by B)
  if ((e = gemm(st, a.c_dgi, 3 * D, a.s_ctx, E, B, a.dawi, E + P2, 3 * D, E, R))) return e;
  if ((e = gemm(st, a.c_dgi, 3 * D, a.pre, P2, 0, a.dawi + E, E + P2, 3 * D, P2, R))) return e;
  if ((e = csum(st, a.c_dgi, 3 * D, a.dabi, 3 * D, R))) return e;
  if ((e = gemm(st, a.c_dgh, 3 * D, a.s_ah, D, B, a.dawh, D, 3 * D, D, R))) return e;
  if ((e = csum(st, a.c_dgh, 3 * D, a.dabh, 3 * D, R))) return e;
  // query projection
  if ((e = gemm(st, a.c_dq, D, a.s_ah, D, 0, a.dwq, D, D, D, R))) return e;
  if ((e = csum(st, a.c_dq, D, a.dqb, D, R))) return e;
  // rnn_input on [ctx | ah]
  if ((e = gemm(st, a.c_dx0, L, a.s_ctx, E, 0, a.dwr, E + D, L, E, R))) return e;
  if ((e = gemm(st, a.c_dx0, L, a.s_ah, D, 0, a.dwr + E, E + D, L, D, R))) return e;
  if ((e = csum(st, a.c_dx0, L, a.dbr, L, R))) return e;
  // the LSTMs: inputs x0 / x1, hiddens h_prev (shifted)
  if ((e = gemm(st, a.c_dg1, 4 * L, a.s_x0, L, 0, a.dl1wi, L, 4 * L, L, R))) return e;
  if ((e = gemm(st, a.c_dg1, 4 * L, a.s_h1, L, B, a.dl1wh, L, 4 * L, L, R))) return e;
  if ((e = csum(st, a.c_dg1, 4 * L, a.dl1b, 4 * L, R))) return e;
  if ((e = gemm(st, a.c_dg2, 4 * L, a.s_x1, L, 0, a.dl2wi, L, 4 * L, L, R))) return e;
  if ((e = gemm(st, a.c_dg2, 4 * L, a.s_h2, L, B, a.dl2wh, L, 4 * L, L, R))) return e;
  if ((e = csum(st, a.c_dg2, 4 * L, a.dl2b, 4 * L, R))) return e;
  // mel_proj (the r frames' rows; AF: the cotangent with Dprev added)
  if ((e = gemm(st, a.dmel, F, a.s_x2, L, 0, a.dwm, L, F, L, R))) return e;
  if (x) {   // the prenet: fc2 on p1 (after its dropout), fc1 on prev
    const int64_t P1 = x->P1, NM = x->NM;
    if ((e = gemm(st, x->c_dp2, P2, x->s_p1, P1, 0, x->dw2, P1, P2, P1, R))) return e;
    if ((e = csum(st, x->c_dp2, P2, x->db2, P2, R))) return e;
    if ((e = gemm(st, x->c_dp1, P1, x->s_prev, NM, 0, x->dw1, NM, P1, NM, R))) return e;
    if ((e = csum(st, x->c_dp1, P1, x->db1, P1, R))) return e;
  }
  // the per-utterance partials: location weight (B, 62, D) -> (D, 62), v
  reduce_parts<<<(unsigned)((NTAP * D + 255) / 256), 256, 0, st>>>(a.pw01, (int)B, NTAP,
                                                                    (int)D, 1, a.dw01);
  if ((e = cudaGetLastError())) return e;
  reduce_parts<<<(unsigned)((D + 255) / 256), 256, 0, st>>>(a.pv, (int)B, 1, (int)D, 0, a.dv);
  return cudaGetLastError();
}

Plan fwd_plan(const TfFwdArgs& a, const AfFwdArgs* x) {
  int64_t lsa = lsa_fwd_floats(a.D, a.T, a.E);
  if (x && af_fwd_floats(a, *x) > lsa) lsa = af_fwd_floats(a, *x);
  return make_plan(a.B, a.D, fwd_row_floats(a), lsa);
}

Plan bwd_plan(const TfBwdArgs& a, const AfBwdArgs* x) {
  const int64_t lsa = lsa_bwd_floats(a.D, a.T, a.E) + (x ? af_bwd_floats(a, *x) : 0);
  return make_plan(a.B, a.D, bwd_row_floats(a), lsa);
}

}  // namespace

#ifndef TACO_TRAIN_HELPERS_ONLY   // taco_tf_resident.cu takes the helpers alone
extern "C" {

// Floats of zeroed workspace the forward / backward needs (both arms).
int64_t wr_taco_tf_fwd_work_floats(const TfFwdArgs* a) { return FwdWork(nullptr, *a).size; }
int64_t wr_taco_tf_bwd_work_floats(const TfBwdArgs* a) { return BwdWork(nullptr, *a).size; }

// Batch rows per staged pass (0: the shapes do not fit).
int64_t wr_taco_tf_fwd_rows(const TfFwdArgs* a) { return fwd_plan(*a, nullptr).bc; }
int64_t wr_taco_tf_bwd_rows(const TfBwdArgs* a) { return bwd_plan(*a, nullptr).bc; }
int64_t wr_taco_af_fwd_rows(const TfFwdArgs* a, const AfFwdArgs* x) {
  return fwd_plan(*a, x).bc;
}
int64_t wr_taco_af_bwd_rows(const TfBwdArgs* a, const AfBwdArgs* x) {
  return bwd_plan(*a, x).bc;
}

// The forward over all G groups on `stream`; returns the CUDA error code.
int wr_taco_tf_fwd(const TfFwdArgs* args, void* stream) {
  TfFwdArgs a = *args;
  const Plan p = fwd_plan(a, nullptr);
  if (p.bc < 1 || a.bc != p.bc) return cudaErrorInvalidValue;
  void* kargs[] = {&a};
  return launch_coop((const void*)taco_tf_fwd, p.smem, kargs, (cudaStream_t)stream);
}

int wr_taco_af_fwd(const TfFwdArgs* args, const AfFwdArgs* xargs, void* stream) {
  TfFwdArgs a = *args;
  AfFwdArgs x = *xargs;
  const Plan p = fwd_plan(a, &x);
  if (p.bc < 1 || a.bc != p.bc || a.pre != x.s_pre) return cudaErrorInvalidValue;
  void* kargs[] = {&a, &x};
  return launch_coop((const void*)taco_af_fwd, p.smem, kargs, (cudaStream_t)stream);
}

// The backward: the reverse sweep, then every weight gradient from the
// cotangent streams it wrote. Returns the CUDA error code.
int wr_taco_tf_bwd(const TfBwdArgs* args, void* stream) {
  TfBwdArgs a = *args;
  const cudaStream_t st = (cudaStream_t)stream;
  const Plan p = bwd_plan(a, nullptr);
  if (p.bc < 1 || a.bc != p.bc) return cudaErrorInvalidValue;
  void* kargs[] = {&a};
  cudaError_t e = launch_coop((const void*)taco_tf_bwd, p.smem, kargs, st);
  if (e != cudaSuccess) return e;
  return wgrads(a, nullptr, st);
}

int wr_taco_af_bwd(const TfBwdArgs* args, const AfBwdArgs* xargs, void* stream) {
  TfBwdArgs a = *args;
  AfBwdArgs x = *xargs;
  const cudaStream_t st = (cudaStream_t)stream;
  const Plan p = bwd_plan(a, &x);
  if (p.bc < 1 || a.bc != p.bc || a.dmel != x.dmel) return cudaErrorInvalidValue;
  void* kargs[] = {&a, &x};
  cudaError_t e = launch_coop((const void*)taco_af_bwd, p.smem, kargs, st);
  if (e != cudaSuccess) return e;
  return wgrads(a, &x, st);
}

}  // extern "C"
#endif  // TACO_TRAIN_HELPERS_ONLY
