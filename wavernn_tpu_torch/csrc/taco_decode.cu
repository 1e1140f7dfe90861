// Tacotron free-running decode for Hopper (sm_90a): every decoder group of
// a batch of utterances in ONE cooperative launch. Two kernels share this
// file's helpers: taco_decode (B2, one utterance) and taco_decode_batch (B8,
// B utterances of right-padded text with per-row stop and freeze).
//
// Replaces:
//   taco_decode        wavernn_tpu/ops/pallas_taco.py, _make_kernel (called
//                      through decode_pallas), the TPU kernel that runs the
//                      batch-1 decoder loop with its weights resident;
//   taco_decode_batch  pallas_taco.py, _make_batch_kernel (decode_pallas_batch,
//                      B <= 8) and _make_stacked_kernel (decode_pallas_stacked,
//                      B > 8): the same function for any B, one kernel (the
//                      TPU's B <= 8 / B > 8 split is a layout matter).
//
// What it computes, per group g (reference tacotron.py:229-286, eval):
//   p      = relu(fc2(relu(fc1(prev_frame))))                 prenet
//   ah     = GRUCell([ctx | p], ah)                           attention rnn
//   loc    = Conv1d(2->32, k=31, pad 15)([cumulative; attention])
//   u_t    = v . tanh(W ah + W.b + L.b + encp_t + L loc_t)   LSA energies
//   s_t    = sigmoid(u_t) * mask_t / sum_t(...)               smooth attention
//   ctx    = sum_t s_t enc_t;  cumulative += s;  attention = s
//   x      = rnn_input([ctx | ah]);  x += LSTM1(x);  x += LSTM2(x)
//   mels   = mel_proj(x), the r frames, frame-major;  prev_frame = last frame
//   stop   : all(mels < stop_threshold) and g*r > 10. From the group after
//            the stop on, the state is frozen: that group's output (computed
//            once from the frozen state) is replayed for every later group.
//            n_valid counts the groups decoded before the stop was set,
//            the trigger group included.
//   B8 does this per row: mask_t is the row's text mask, a row that stops
//   freezes alone while the others go on, and once every row has stopped
//   one more group computes every row's frozen output, replayed from then.
//
// What bounds it: latency. Every group is a chain of ten stages that
// depend on each other across the whole grid (matrix-vector products over
// the ~5.9M decoder weights, 23.6 MB in float32, for B rows), and every group
// depends on the previous one; counted once, its FLOPs and bytes are small
// for the card.
//
// Design: one persistent cooperative launch, one block per SM; a warp per
// output unit (lanes across the reduction axis, 16-byte loads), a grid
// barrier between dependent stages. The LSA runs a warp per text position
// with the location conv, the L projection (its weight transposed in shared
// memory) and the energy reduction in registers. Weights stay in device
// memory (they fit in the 50 MB L2). State ping-pongs between two buffers and
// is committed by flipping the index, so a frozen group simply does not
// flip. Every block derives the stop flag itself from the group's mels in
// device memory after the barrier, so all blocks take the same branch
// without another barrier and the host never synchronises inside the loop.
// B8: a warp takes one (output unit, tile of 4 rows) item, so B rows spread
// over more warps; each row has its own ping-pong index, flipped only while
// the row is live, kept identically in every block's shared memory; the
// LSA takes (row, position) pairs. Shared memory and the workspace grow with
// B * T_text: ops/cuda_taco.py splits a batch into launches that fit.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int LOC_CH = 32;    // location conv channels (tacotron.py:176)
constexpr int CONV_K = 31;
constexpr int CONV_HALF = 15;
}  // namespace

// Mirrored field for field by ops/cuda_taco.py (ctypes): 8-byte fields only.
struct DecodeArgs {
  const float* enc;    // (T, E)
  const float* encp;   // (T, D)
  const float* mask;   // (T,)
  const float* w1p;    // (P1, n_mels)   prenet fc1
  const float* b1p;    // (P1,)
  const float* w2p;    // (P2, P1)       prenet fc2
  const float* b2p;    // (P2,)
  const float* awi;    // (3D, E + P2)   attention GRUCell, input [ctx | p]
  const float* abi;    // (3D,)
  const float* awh;    // (3D, D)
  const float* abh;    // (3D,)
  const float* wq;     // (D, D)         attn W
  const float* qb;     // (D,)           W.b + L.b
  const float* conv;   // (32, 2, 31)    location conv
  const float* lw;     // (D, 32)        attn L
  const float* v;      // (D,)           attn v
  const float* wr;     // (L, E + D)     rnn_input, input [ctx | ah]
  const float* br;     // (L,)
  const float* l1wi;   // (4L, L)
  const float* l1wh;   // (4L, L)
  const float* l1b;    // (4L,)          bias_ih + bias_hh
  const float* l2wi;
  const float* l2wh;
  const float* l2b;
  const float* wm;     // (F, L)         mel_proj rows for the r frames, frame-major
  float* mel_out;      // (n_groups, F)
  float* att_out;      // (n_groups, T)
  int32_t* n_valid;    // (1,)
  float* work;         // zeroed workspace, see Work below
  int64_t T, E, D, P1, P2, L, n_mels, r, n_groups;
  double stop_threshold;
};

namespace {

__host__ __device__ inline int64_t up4(int64_t n) { return (n + 3) / 4 * 4; }

struct Work {  // views into DecodeArgs::work; every buffer 16-byte aligned
  float *p1, *p2, *q, *sig, *xin, *x1, *x2;
  float *ah[2], *ctx[2], *cum[2], *att[2], *h1[2], *c1[2], *h2[2], *c2[2], *mel[2];
  int64_t size = 0;  // floats
  __host__ __device__ Work(float* w, const DecodeArgs& a) {
    const int64_t T = up4(a.T), F = up4(a.r * a.n_mels);
    auto take = [&](int64_t n) {
      float* p = w ? w + size : nullptr;
      size += up4(n);
      return p;
    };
    p1 = take(a.P1); p2 = take(a.P2); q = take(a.D); sig = take(T);
    xin = take(a.L); x1 = take(a.L); x2 = take(a.L);
    for (int i = 0; i < 2; ++i) {
      ah[i] = take(a.D); ctx[i] = take(a.E); cum[i] = take(T); att[i] = take(T);
      h1[i] = take(a.L); c1[i] = take(a.L); h2[i] = take(a.L); c2[i] = take(a.L);
      mel[i] = take(F);
    }
  }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float sigmoidf(float x) { return 1.f / (1.f + expf(-x)); }

// The input vector [a (na floats) | b], read through L2: other blocks wrote
// it before the last grid barrier.
struct Vec2 {
  const float* a;
  int na;
  const float* b;
  __device__ float4 at(int k) const {
    return k < na ? __ldcg(reinterpret_cast<const float4*>(a + k))
                  : __ldcg(reinterpret_cast<const float4*>(b + (k - na)));
  }
};

// NG warp-wide dot products: rows g*gstride + j (length n) of w against x.
template <int NG>
__device__ __forceinline__ void warp_dots(const float* __restrict__ w, int j,
                                          int gstride, int n, const Vec2& x,
                                          float (&acc)[NG]) {
#pragma unroll
  for (int g = 0; g < NG; ++g) acc[g] = 0.f;
  for (int k = (threadIdx.x & 31) * 4; k < n; k += 128) {
    const float4 xv = x.at(k);
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      const float4 wv = __ldg(reinterpret_cast<const float4*>(
          w + ((size_t)g * gstride + j) * n + k));
      acc[g] = fmaf(wv.x, xv.x, acc[g]);
      acc[g] = fmaf(wv.y, xv.y, acc[g]);
      acc[g] = fmaf(wv.z, xv.z, acc[g]);
      acc[g] = fmaf(wv.w, xv.w, acc[g]);
    }
  }
#pragma unroll
  for (int g = 0; g < NG; ++g) acc[g] = warp_sum(acc[g]);
}

__device__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
  for (int w = 0; w < WARPS; ++w) s += red[w];
  return s;
}

__global__ void __launch_bounds__(THREADS, 1) taco_decode(DecodeArgs a) {
  cg::grid_group grid = cg::this_grid();
  const int T = (int)a.T, E = (int)a.E, D = (int)a.D, P1 = (int)a.P1;
  const int P2 = (int)a.P2, L = (int)a.L, n_mels = (int)a.n_mels;
  const int r = (int)a.r, F = r * n_mels;
  const float thr = (float)a.stop_threshold;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gw = warp * gridDim.x + blockIdx.x, nw = WARPS * gridDim.x;
  const int gt = threadIdx.x * gridDim.x + blockIdx.x, nt = THREADS * gridDim.x;
  Work wk(a.work, a);

  extern __shared__ float smem[];
  float* s_conv = smem;                          // (32, 2, 31)
  float* s_lwT = s_conv + LOC_CH * 2 * CONV_K;   // (32, D): L weight transposed
  float* s_v = s_lwT + LOC_CH * D;               // (D,)
  float* s_q = s_v + D;                          // (D,)
  float* s_cum = s_q + D;                        // (T,)
  float* s_att = s_cum + T;                      // (T,)
  float* s_red = s_att + T;                      // (WARPS,)
  float* s_scores = s_cum;                       // stage 6 reuses cum/att
  for (int e = threadIdx.x; e < LOC_CH * 2 * CONV_K; e += THREADS) s_conv[e] = a.conv[e];
  for (int e = threadIdx.x; e < LOC_CH * D; e += THREADS)
    s_lwT[(e % LOC_CH) * D + e / LOC_CH] = a.lw[e];
  for (int e = threadIdx.x; e < D; e += THREADS) s_v[e] = a.v[e];
  __syncthreads();

  int cur = 0, valid = 0;
  bool stopped = false, held = false;
  for (int g = 0; g < (int)a.n_groups; ++g) {
    const int nxt = cur ^ 1;
    if (!(stopped && held)) {
      // ---- 1, 2: prenet on the previous group's last frame ----
      {
        const Vec2 x{wk.mel[cur] + (r - 1) * n_mels, n_mels, nullptr};
        for (int j = gw; j < P1; j += nw) {
          float acc[1];
          warp_dots<1>(a.w1p, j, 0, n_mels, x, acc);
          if (lane == 0) wk.p1[j] = fmaxf(acc[0] + a.b1p[j], 0.f);
        }
      }
      grid.sync();
      {
        const Vec2 x{wk.p1, P1, nullptr};
        for (int j = gw; j < P2; j += nw) {
          float acc[1];
          warp_dots<1>(a.w2p, j, 0, P1, x, acc);
          if (lane == 0) wk.p2[j] = fmaxf(acc[0] + a.b2p[j], 0.f);
        }
      }
      grid.sync();
      // ---- 3: attention GRUCell on [ctx | p] ----
      {
        const Vec2 xi{wk.ctx[cur], E, wk.p2};
        const Vec2 xh{wk.ah[cur], D, nullptr};
        for (int j = gw; j < D; j += nw) {
          float gi[3], gh[3];
          warp_dots<3>(a.awi, j, D, E + P2, xi, gi);
          warp_dots<3>(a.awh, j, D, D, xh, gh);
          if (lane == 0) {
            const float rr = sigmoidf((gi[0] + a.abi[j]) + (gh[0] + a.abh[j]));
            const float z = sigmoidf((gi[1] + a.abi[D + j]) + (gh[1] + a.abh[D + j]));
            const float n = tanhf((gi[2] + a.abi[2 * D + j]) + rr * (gh[2] + a.abh[2 * D + j]));
            wk.ah[nxt][j] = (1.f - z) * n + z * __ldcg(wk.ah[cur] + j);
          }
        }
      }
      grid.sync();
      // ---- 4: query projection (W ah + W.b + L.b) ----
      {
        const Vec2 x{wk.ah[nxt], D, nullptr};
        for (int j = gw; j < D; j += nw) {
          float acc[1];
          warp_dots<1>(a.wq, j, 0, D, x, acc);
          if (lane == 0) wk.q[j] = acc[0] + a.qb[j];
        }
      }
      grid.sync();
      // ---- 5: LSA energies, a warp per text position ----
      for (int e = threadIdx.x; e < D; e += THREADS) s_q[e] = __ldcg(wk.q + e);
      for (int e = threadIdx.x; e < T; e += THREADS) {
        s_cum[e] = __ldcg(wk.cum[cur] + e);
        s_att[e] = __ldcg(wk.att[cur] + e);
      }
      __syncthreads();
      for (int t = gw; t < T; t += nw) {
        float loc = 0.f;  // lane = location channel
        const float* cw = s_conv + lane * 2 * CONV_K;
        for (int k = 0; k < CONV_K; ++k) {
          const int s = t + k - CONV_HALF;
          if (s >= 0 && s < T) {
            loc = fmaf(cw[k], s_cum[s], loc);
            loc = fmaf(cw[CONV_K + k], s_att[s], loc);
          }
        }
        float u = 0.f;
        for (int d = lane; d < D; d += 32) {
          float ll = 0.f;
          for (int f = 0; f < LOC_CH; ++f)
            ll = fmaf(__shfl_sync(0xffffffffu, loc, f), s_lwT[f * D + d], ll);
          const float arg = tanhf((s_q[d] + a.encp[(size_t)t * D + d]) + ll);
          u = fmaf(s_v[d], arg, u);
        }
        u = warp_sum(u);
        if (lane == 0) wk.sig[t] = sigmoidf(u) * a.mask[t];
      }
      grid.sync();
      // ---- 6: normalise, context, attention state ----
      {
        float part = 0.f;
        for (int t = threadIdx.x; t < T; t += THREADS) part += __ldcg(wk.sig + t);
        const float total = block_sum(part, s_red);
        for (int t = threadIdx.x; t < T; t += THREADS)
          s_scores[t] = __ldcg(wk.sig + t) / total;
        __syncthreads();
        for (int e = gt; e < E + T; e += nt) {
          if (e < E) {
            float c = 0.f;
            for (int t = 0; t < T; ++t) c = fmaf(s_scores[t], a.enc[(size_t)t * E + e], c);
            wk.ctx[nxt][e] = c;
          } else {
            const int t = e - E;
            wk.att[nxt][t] = s_scores[t];
            wk.cum[nxt][t] = __ldcg(wk.cum[cur] + t) + s_scores[t];
          }
        }
      }
      grid.sync();
      // ---- 7: rnn_input on [ctx | ah] ----
      {
        const Vec2 x{wk.ctx[nxt], E, wk.ah[nxt]};
        for (int j = gw; j < L; j += nw) {
          float acc[1];
          warp_dots<1>(a.wr, j, 0, E + D, x, acc);
          if (lane == 0) wk.xin[j] = acc[0] + a.br[j];
        }
      }
      grid.sync();
      // ---- 8, 9: residual LSTMCells ----
      for (int layer = 0; layer < 2; ++layer) {
        const float* wi = layer == 0 ? a.l1wi : a.l2wi;
        const float* wh = layer == 0 ? a.l1wh : a.l2wh;
        const float* b = layer == 0 ? a.l1b : a.l2b;
        const float* xin = layer == 0 ? wk.xin : wk.x1;
        float* xout = layer == 0 ? wk.x1 : wk.x2;
        const float* h_cur = layer == 0 ? wk.h1[cur] : wk.h2[cur];
        const float* c_cur = layer == 0 ? wk.c1[cur] : wk.c2[cur];
        float* h_nxt = layer == 0 ? wk.h1[nxt] : wk.h2[nxt];
        float* c_nxt = layer == 0 ? wk.c1[nxt] : wk.c2[nxt];
        const Vec2 xi{xin, L, nullptr}, xh{h_cur, L, nullptr};
        for (int j = gw; j < L; j += nw) {
          float gi[4], gh[4];
          warp_dots<4>(wi, j, L, L, xi, gi);
          warp_dots<4>(wh, j, L, L, xh, gh);
          if (lane == 0) {
            const float ig = sigmoidf(gi[0] + gh[0] + b[j]);
            const float fg = sigmoidf(gi[1] + gh[1] + b[L + j]);
            const float gg = tanhf(gi[2] + gh[2] + b[2 * L + j]);
            const float og = sigmoidf(gi[3] + gh[3] + b[3 * L + j]);
            const float c = fg * __ldcg(c_cur + j) + ig * gg;
            const float h = og * tanhf(c);
            c_nxt[j] = c;
            h_nxt[j] = h;
            xout[j] = __ldcg(xin + j) + h;
          }
        }
        grid.sync();
      }
      // ---- 10: mel_proj, the r frames ----
      {
        const Vec2 x{wk.x2, L, nullptr};
        for (int f = gw; f < F; f += nw) {
          float acc[1];
          warp_dots<1>(a.wm, f, 0, L, x, acc);
          if (lane == 0) wk.mel[nxt][f] = acc[0];
        }
      }
      grid.sync();
      // ---- stop test, commit or freeze (every block, same answer) ----
      bool below = true;
      for (int f = threadIdx.x; f < F; f += THREADS) below &= __ldcg(wk.mel[nxt] + f) < thr;
      const bool hit = __syncthreads_and(below) && g * r > 10;
      if (!stopped) {
        ++valid;
        stopped = hit;
        cur = nxt;  // commit the new state
      } else {
        held = true;  // frozen-state group: replayed from here on
      }
    }
    // ---- emit: the live group or the frozen replay ----
    if (blockIdx.x == 0) {
      const int src = held ? (cur ^ 1) : cur;  // buffers this group's output went to
      for (int f = threadIdx.x; f < F; f += THREADS)
        a.mel_out[(size_t)g * F + f] = __ldcg(wk.mel[src] + f);
      for (int t = threadIdx.x; t < T; t += THREADS)
        a.att_out[(size_t)g * T + t] = __ldcg(wk.att[src] + t);
    }
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) a.n_valid[0] = valid;
}

size_t shared_bytes(const DecodeArgs& a) {
  return (size_t)(LOC_CH * 2 * CONV_K + LOC_CH * a.D + 2 * a.D + 2 * a.T + WARPS)
         * sizeof(float);
}

}  // namespace

// B8's arguments, mirrored field for field by ops/cuda_taco.py (ctypes):
// 8-byte fields only. The weights are B2's.
struct BatchArgs {
  const float* enc;    // (B, T, E)
  const float* encp;   // (B, T, D)
  const float* mask;   // (B, T)          1 on a row's text, 0 on its padding
  const float* w1p;
  const float* b1p;
  const float* w2p;
  const float* b2p;
  const float* awi;
  const float* abi;
  const float* awh;
  const float* abh;
  const float* wq;
  const float* qb;
  const float* conv;
  const float* lw;
  const float* v;
  const float* wr;
  const float* br;
  const float* l1wi;
  const float* l1wh;
  const float* l1b;
  const float* l2wi;
  const float* l2wh;
  const float* l2b;
  const float* wm;
  float* mel_out;      // (B, n_groups, F)
  float* att_out;      // (B, n_groups, T)
  int32_t* n_valid;    // (B,)
  float* work;         // zeroed workspace, see BWork below
  int64_t B, T, E, D, P1, P2, L, n_mels, r, n_groups;
  double stop_threshold;
};

namespace {

constexpr int RT = 4;  // rows of one warp item

struct BWork {  // views into BatchArgs::work; every row 16-byte aligned
  int64_t Tp, Fp;  // padded row widths of the T- and F-long buffers
  float *p1, *p2, *q, *sig, *xin, *x1, *x2;            // (B, .)
  float *ah, *ctx, *cum, *att, *h1, *c1, *h2, *c2, *mel;  // (2, B, .)
  int64_t size = 0;  // floats
  __host__ __device__ BWork(float* w, const BatchArgs& a)
      : Tp(up4(a.T)), Fp(up4(a.r * a.n_mels)) {
    const int64_t B = a.B;
    auto take = [&](int64_t n) {
      float* p = w ? w + size : nullptr;
      size += up4(n);
      return p;
    };
    p1 = take(B * a.P1); p2 = take(B * a.P2); q = take(B * a.D);
    sig = take(B * Tp); xin = take(B * a.L); x1 = take(B * a.L);
    x2 = take(B * a.L);
    ah = take(2 * B * a.D); ctx = take(2 * B * a.E); cum = take(2 * B * Tp);
    att = take(2 * B * Tp); h1 = take(2 * B * a.L); c1 = take(2 * B * a.L);
    h2 = take(2 * B * a.L); c2 = take(2 * B * a.L); mel = take(2 * B * Fp);
  }
};

// Row b of a ping-pong buffer (2, B, w) at index i.
__device__ __forceinline__ float* pp(float* base, int64_t w, int i, int b, int B) {
  return base + ((int64_t)i * B + b) * w;
}

// The input vectors [a (na floats) | b] of up to RT rows, read through L2:
// other blocks wrote them before the last grid barrier.
struct Rows {
  const float* a[RT];
  const float* b[RT];
  int na;
  __device__ float4 at(int r, int k) const {
    return k < na ? __ldcg(reinterpret_cast<const float4*>(a[r] + k))
                  : __ldcg(reinterpret_cast<const float4*>(b[r] + (k - na)));
  }
};

// NG warp-wide dot products per row: weight rows g*gstride + j (length n)
// against the first nb rows of x. Each row's sum runs in B2's order.
template <int NG>
__device__ __forceinline__ void row_dots(const float* __restrict__ w, int j,
                                         int gstride, int n, const Rows& x,
                                         int nb, float (&acc)[NG][RT]) {
#pragma unroll
  for (int g = 0; g < NG; ++g)
#pragma unroll
    for (int r = 0; r < RT; ++r) acc[g][r] = 0.f;
  for (int k = (threadIdx.x & 31) * 4; k < n; k += 128) {
    float4 wv[NG];
#pragma unroll
    for (int g = 0; g < NG; ++g)
      wv[g] = __ldg(reinterpret_cast<const float4*>(w + ((size_t)g * gstride + j) * n + k));
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      if (r < nb) {
        const float4 xv = x.at(r, k);
#pragma unroll
        for (int g = 0; g < NG; ++g) {
          acc[g][r] = fmaf(wv[g].x, xv.x, acc[g][r]);
          acc[g][r] = fmaf(wv[g].y, xv.y, acc[g][r]);
          acc[g][r] = fmaf(wv[g].z, xv.z, acc[g][r]);
          acc[g][r] = fmaf(wv[g].w, xv.w, acc[g][r]);
        }
      }
    }
  }
#pragma unroll
  for (int g = 0; g < NG; ++g)
#pragma unroll
    for (int r = 0; r < RT; ++r)
      if (r < nb) acc[g][r] = warp_sum(acc[g][r]);
}

// acc[g][r] with r a runtime lane index, without local memory
template <int NG>
__device__ __forceinline__ float pick(const float (&acc)[NG][RT], int g, int r) {
  float v = 0.f;
#pragma unroll
  for (int rr = 0; rr < RT; ++rr)
    if (rr == r) v = acc[g][rr];
  return v;
}

__global__ void __launch_bounds__(THREADS, 1) taco_decode_batch(BatchArgs a) {
  cg::grid_group grid = cg::this_grid();
  const int B = (int)a.B, T = (int)a.T, E = (int)a.E, D = (int)a.D;
  const int P1 = (int)a.P1, P2 = (int)a.P2, L = (int)a.L;
  const int n_mels = (int)a.n_mels, r = (int)a.r, F = r * n_mels;
  const float thr = (float)a.stop_threshold;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gw = warp * gridDim.x + blockIdx.x, nw = WARPS * gridDim.x;
  const int gt = threadIdx.x * gridDim.x + blockIdx.x, nt = THREADS * gridDim.x;
  const int tiles = (B + RT - 1) / RT;
  BWork wk(a.work, a);
  const int64_t Tp = wk.Tp, Fp = wk.Fp;

  extern __shared__ float smem[];
  float* s_conv = smem;                          // (32, 2, 31)
  float* s_lwT = s_conv + LOC_CH * 2 * CONV_K;   // (32, D): L weight transposed
  float* s_v = s_lwT + LOC_CH * D;               // (D,)
  float* s_q = s_v + D;                          // (B, D)
  float* s_cum = s_q + B * D;                    // (B, T)
  float* s_att = s_cum + B * T;                  // (B, T)
  float* s_tot = s_att + B * T;                  // (B,)
  int* s_cur = reinterpret_cast<int*>(s_tot + B);  // (B,) live ping-pong index
  int* s_stop = s_cur + B;                       // (B,) stopped before this group
  int* s_valid = s_stop + B;                     // (B,) groups decoded live
  int* s_src = s_valid + B;                      // (B,) buffer of this group's output
  int* s_hit = s_src + B;                        // (B,) this group's stop test
  float* s_scores = s_cum;                       // stage 6 reuses cum/att
  for (int e = threadIdx.x; e < LOC_CH * 2 * CONV_K; e += THREADS) s_conv[e] = a.conv[e];
  for (int e = threadIdx.x; e < LOC_CH * D; e += THREADS)
    s_lwT[(e % LOC_CH) * D + e / LOC_CH] = a.lw[e];
  for (int e = threadIdx.x; e < D; e += THREADS) s_v[e] = a.v[e];
  for (int b = threadIdx.x; b < B; b += THREADS) {
    s_cur[b] = 0;
    s_stop[b] = 0;
    s_valid[b] = 0;
    s_src[b] = 0;
  }
  __syncthreads();

  // the rows of item `it` of a stage over `units` output units
  auto item = [&](int it, int& j, int& b0, int& nb) {
    j = it / tiles;
    b0 = (it % tiles) * RT;
    nb = min(RT, B - b0);
  };
  auto row = [&](int b0, int rr) { return min(b0 + rr, B - 1); };

  bool held = false;
  for (int g = 0; g < (int)a.n_groups; ++g) {
    bool all_frozen = true;
    for (int b = 0; b < B; ++b) all_frozen &= s_stop[b] != 0;
    if (!(all_frozen && held)) {
      // ---- 1, 2: prenet on each row's previous last frame ----
      for (int it = gw; it < P1 * tiles; it += nw) {
        int j, b0, nb;
        item(it, j, b0, nb);
        Rows x;
        x.na = n_mels;
        for (int rr = 0; rr < RT; ++rr) {
          const int b = row(b0, rr);
          x.a[rr] = pp(wk.mel, Fp, s_cur[b], b, B) + (r - 1) * n_mels;
          x.b[rr] = nullptr;
        }
        float acc[1][RT];
        row_dots<1>(a.w1p, j, 0, n_mels, x, nb, acc);
        if (lane < nb) wk.p1[(size_t)(b0 + lane) * P1 + j] = fmaxf(pick<1>(acc, 0, lane) + a.b1p[j], 0.f);
      }
      grid.sync();
      for (int it = gw; it < P2 * tiles; it += nw) {
        int j, b0, nb;
        item(it, j, b0, nb);
        Rows x;
        x.na = P1;
        for (int rr = 0; rr < RT; ++rr) {
          x.a[rr] = wk.p1 + (size_t)row(b0, rr) * P1;
          x.b[rr] = nullptr;
        }
        float acc[1][RT];
        row_dots<1>(a.w2p, j, 0, P1, x, nb, acc);
        if (lane < nb) wk.p2[(size_t)(b0 + lane) * P2 + j] = fmaxf(pick<1>(acc, 0, lane) + a.b2p[j], 0.f);
      }
      grid.sync();
      // ---- 3: attention GRUCell on [ctx | p] ----
      for (int it = gw; it < D * tiles; it += nw) {
        int j, b0, nb;
        item(it, j, b0, nb);
        Rows xi, xh;
        xi.na = E;
        xh.na = D;
        for (int rr = 0; rr < RT; ++rr) {
          const int b = row(b0, rr);
          xi.a[rr] = pp(wk.ctx, E, s_cur[b], b, B);
          xi.b[rr] = wk.p2 + (size_t)b * P2;
          xh.a[rr] = pp(wk.ah, D, s_cur[b], b, B);
          xh.b[rr] = nullptr;
        }
        float gi[3][RT], gh[3][RT];
        row_dots<3>(a.awi, j, D, E + P2, xi, nb, gi);
        row_dots<3>(a.awh, j, D, D, xh, nb, gh);
        if (lane < nb) {
          const int b = b0 + lane;
          const float rr_ = sigmoidf((pick<3>(gi, 0, lane) + a.abi[j]) + (pick<3>(gh, 0, lane) + a.abh[j]));
          const float z = sigmoidf((pick<3>(gi, 1, lane) + a.abi[D + j]) + (pick<3>(gh, 1, lane) + a.abh[D + j]));
          const float n = tanhf((pick<3>(gi, 2, lane) + a.abi[2 * D + j])
                                + rr_ * (pick<3>(gh, 2, lane) + a.abh[2 * D + j]));
          pp(wk.ah, D, s_cur[b] ^ 1, b, B)[j] =
              (1.f - z) * n + z * __ldcg(pp(wk.ah, D, s_cur[b], b, B) + j);
        }
      }
      grid.sync();
      // ---- 4: query projection (W ah + W.b + L.b) ----
      for (int it = gw; it < D * tiles; it += nw) {
        int j, b0, nb;
        item(it, j, b0, nb);
        Rows x;
        x.na = D;
        for (int rr = 0; rr < RT; ++rr) {
          const int b = row(b0, rr);
          x.a[rr] = pp(wk.ah, D, s_cur[b] ^ 1, b, B);
          x.b[rr] = nullptr;
        }
        float acc[1][RT];
        row_dots<1>(a.wq, j, 0, D, x, nb, acc);
        if (lane < nb) wk.q[(size_t)(b0 + lane) * D + j] = pick<1>(acc, 0, lane) + a.qb[j];
      }
      grid.sync();
      // ---- 5: LSA energies, a warp per (row, text position) ----
      for (int e = threadIdx.x; e < B * D; e += THREADS) s_q[e] = __ldcg(wk.q + e);
      for (int e = threadIdx.x; e < B * T; e += THREADS) {
        const int b = e / T, t = e % T;
        s_cum[e] = __ldcg(pp(wk.cum, Tp, s_cur[b], b, B) + t);
        s_att[e] = __ldcg(pp(wk.att, Tp, s_cur[b], b, B) + t);
      }
      __syncthreads();
      for (int pr = gw; pr < B * T; pr += nw) {
        const int b = pr / T, t = pr % T;
        const float* cum = s_cum + b * T;
        const float* att = s_att + b * T;
        float loc = 0.f;  // lane = location channel
        const float* cw = s_conv + lane * 2 * CONV_K;
        for (int k = 0; k < CONV_K; ++k) {
          const int s = t + k - CONV_HALF;
          if (s >= 0 && s < T) {
            loc = fmaf(cw[k], cum[s], loc);
            loc = fmaf(cw[CONV_K + k], att[s], loc);
          }
        }
        const float* ep = a.encp + ((size_t)b * T + t) * D;
        const float* q = s_q + b * D;
        float u = 0.f;
        for (int d = lane; d < D; d += 32) {
          float ll = 0.f;
          for (int f = 0; f < LOC_CH; ++f)
            ll = fmaf(__shfl_sync(0xffffffffu, loc, f), s_lwT[f * D + d], ll);
          const float arg = tanhf((q[d] + ep[d]) + ll);
          u = fmaf(s_v[d], arg, u);
        }
        u = warp_sum(u);
        if (lane == 0) wk.sig[(size_t)b * Tp + t] = sigmoidf(u) * a.mask[(size_t)b * T + t];
      }
      grid.sync();
      // ---- 6: normalise, context, attention state ----
      for (int b = warp; b < B; b += WARPS) {
        float part = 0.f;
        for (int t = lane; t < T; t += 32) part += __ldcg(wk.sig + (size_t)b * Tp + t);
        part = warp_sum(part);
        if (lane == 0) s_tot[b] = part;
      }
      __syncthreads();
      for (int e = threadIdx.x; e < B * T; e += THREADS) {
        const int b = e / T, t = e % T;
        s_scores[e] = __ldcg(wk.sig + (size_t)b * Tp + t) / s_tot[b];
      }
      __syncthreads();
      for (int e = gt; e < B * (E + T); e += nt) {
        const int b = e / (E + T), k = e % (E + T);
        const int nx = s_cur[b] ^ 1;
        const float* sc = s_scores + b * T;
        if (k < E) {
          const float* en = a.enc + (size_t)b * T * E + k;
          float c = 0.f;
          for (int t = 0; t < T; ++t) c = fmaf(sc[t], en[(size_t)t * E], c);
          pp(wk.ctx, E, nx, b, B)[k] = c;
        } else {
          const int t = k - E;
          pp(wk.att, Tp, nx, b, B)[t] = sc[t];
          pp(wk.cum, Tp, nx, b, B)[t] = __ldcg(pp(wk.cum, Tp, s_cur[b], b, B) + t) + sc[t];
        }
      }
      grid.sync();
      // ---- 7: rnn_input on [ctx | ah] ----
      for (int it = gw; it < L * tiles; it += nw) {
        int j, b0, nb;
        item(it, j, b0, nb);
        Rows x;
        x.na = E;
        for (int rr = 0; rr < RT; ++rr) {
          const int b = row(b0, rr);
          x.a[rr] = pp(wk.ctx, E, s_cur[b] ^ 1, b, B);
          x.b[rr] = pp(wk.ah, D, s_cur[b] ^ 1, b, B);
        }
        float acc[1][RT];
        row_dots<1>(a.wr, j, 0, E + D, x, nb, acc);
        if (lane < nb) wk.xin[(size_t)(b0 + lane) * L + j] = pick<1>(acc, 0, lane) + a.br[j];
      }
      grid.sync();
      // ---- 8, 9: residual LSTMCells ----
      for (int layer = 0; layer < 2; ++layer) {
        const float* wi = layer == 0 ? a.l1wi : a.l2wi;
        const float* wh = layer == 0 ? a.l1wh : a.l2wh;
        const float* bias = layer == 0 ? a.l1b : a.l2b;
        const float* xin = layer == 0 ? wk.xin : wk.x1;
        float* xout = layer == 0 ? wk.x1 : wk.x2;
        float* hb = layer == 0 ? wk.h1 : wk.h2;
        float* cb = layer == 0 ? wk.c1 : wk.c2;
        for (int it = gw; it < L * tiles; it += nw) {
          int j, b0, nb;
          item(it, j, b0, nb);
          Rows xi, xh;
          xi.na = L;
          xh.na = L;
          for (int rr = 0; rr < RT; ++rr) {
            const int b = row(b0, rr);
            xi.a[rr] = xin + (size_t)b * L;
            xi.b[rr] = nullptr;
            xh.a[rr] = pp(hb, L, s_cur[b], b, B);
            xh.b[rr] = nullptr;
          }
          float gi[4][RT], gh[4][RT];
          row_dots<4>(wi, j, L, L, xi, nb, gi);
          row_dots<4>(wh, j, L, L, xh, nb, gh);
          if (lane < nb) {
            const int b = b0 + lane;
            const float ig = sigmoidf(pick<4>(gi, 0, lane) + pick<4>(gh, 0, lane) + bias[j]);
            const float fg = sigmoidf(pick<4>(gi, 1, lane) + pick<4>(gh, 1, lane) + bias[L + j]);
            const float gg = tanhf(pick<4>(gi, 2, lane) + pick<4>(gh, 2, lane) + bias[2 * L + j]);
            const float og = sigmoidf(pick<4>(gi, 3, lane) + pick<4>(gh, 3, lane) + bias[3 * L + j]);
            const float c = fg * __ldcg(pp(cb, L, s_cur[b], b, B) + j) + ig * gg;
            const float h = og * tanhf(c);
            pp(cb, L, s_cur[b] ^ 1, b, B)[j] = c;
            pp(hb, L, s_cur[b] ^ 1, b, B)[j] = h;
            xout[(size_t)b * L + j] = __ldcg(xin + (size_t)b * L + j) + h;
          }
        }
        grid.sync();
      }
      // ---- 10: mel_proj, the r frames ----
      for (int it = gw; it < F * tiles; it += nw) {
        int j, b0, nb;
        item(it, j, b0, nb);
        Rows x;
        x.na = L;
        for (int rr = 0; rr < RT; ++rr) {
          x.a[rr] = wk.x2 + (size_t)row(b0, rr) * L;
          x.b[rr] = nullptr;
        }
        float acc[1][RT];
        row_dots<1>(a.wm, j, 0, L, x, nb, acc);
        if (lane < nb) {
          const int b = b0 + lane;
          pp(wk.mel, Fp, s_cur[b] ^ 1, b, B)[j] = pick<1>(acc, 0, lane);
        }
      }
      grid.sync();
      // ---- per-row stop test, commit or freeze (every block, same answer) ----
      for (int b = warp; b < B; b += WARPS) {
        const float* m = pp(wk.mel, Fp, s_cur[b] ^ 1, b, B);
        bool below = true;
        for (int f = lane; f < F; f += 32) below &= __ldcg(m + f) < thr;
        below = __all_sync(0xffffffffu, below);
        if (lane == 0) s_hit[b] = below && g * r > 10;
      }
      __syncthreads();
      for (int b = threadIdx.x; b < B; b += THREADS) {
        if (!s_stop[b]) {
          ++s_valid[b];
          s_stop[b] = s_hit[b];
          s_cur[b] ^= 1;  // commit the row's new state
          s_src[b] = s_cur[b];
        } else {
          s_src[b] = s_cur[b] ^ 1;  // the frozen state's output
        }
      }
      __syncthreads();
      held = all_frozen;  // every row frozen: this output is replayed
    }
    // ---- emit: each row's live group or its frozen replay ----
    if (blockIdx.x == 0) {
      for (int e = threadIdx.x; e < B * F; e += THREADS) {
        const int b = e / F, f = e % F;
        a.mel_out[((size_t)b * a.n_groups + g) * F + f] = __ldcg(pp(wk.mel, Fp, s_src[b], b, B) + f);
      }
      for (int e = threadIdx.x; e < B * T; e += THREADS) {
        const int b = e / T, t = e % T;
        a.att_out[((size_t)b * a.n_groups + g) * T + t] = __ldcg(pp(wk.att, Tp, s_src[b], b, B) + t);
      }
    }
  }
  if (blockIdx.x == 0)
    for (int b = threadIdx.x; b < B; b += THREADS) a.n_valid[b] = s_valid[b];
}

size_t batch_shared_bytes(const BatchArgs& a) {
  return (size_t)(LOC_CH * 2 * CONV_K + LOC_CH * a.D + a.D + a.B * a.D + 2 * a.B * a.T
                  + a.B) * sizeof(float)
         + (size_t)5 * a.B * sizeof(int);
}

int launch_coop(const void* fn, void* kargs, size_t smem, void* stream) {
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
  void* args[] = {kargs};
  e = cudaLaunchCooperativeKernel(fn, dim3(sms), dim3(THREADS), args, smem,
                                  (cudaStream_t)stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Floats of workspace the launch needs (zero-filled by the caller).
int64_t wr_taco_decode_work_floats(const DecodeArgs* args) {
  return Work(nullptr, *args).size;
}

// Launches the decode on `stream`; returns the CUDA error code (0 = launched).
int wr_taco_decode(const DecodeArgs* args, void* stream) {
  DecodeArgs a = *args;
  return launch_coop((const void*)taco_decode, &a, shared_bytes(a), stream);
}

// B8: floats of workspace and bytes of shared memory a launch needs.
int64_t wr_taco_decode_batch_work_floats(const BatchArgs* args) {
  return BWork(nullptr, *args).size;
}

int64_t wr_taco_decode_batch_shared_bytes(const BatchArgs* args) {
  return (int64_t)batch_shared_bytes(*args);
}

// B8: launches the batched decode on `stream`; returns the CUDA error code.
int wr_taco_decode_batch(const BatchArgs* args, void* stream) {
  BatchArgs a = *args;
  return launch_coop((const void*)taco_decode_batch, &a, batch_shared_bytes(a),
                     stream);
}

}  // extern "C"
