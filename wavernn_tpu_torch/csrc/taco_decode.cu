// Tacotron free-running decode for Hopper (sm_90a): every decoder group of
// one utterance in ONE cooperative launch.
//
// Replaces: wavernn_tpu/ops/pallas_taco.py, _make_kernel (called through
// decode_pallas), the TPU kernel that runs the batch-1 decoder loop with
// its weights resident.
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
//
// What bounds it: latency. At batch 1 every group is a chain of ten stages
// that depend on each other across the whole grid (matrix-vector products
// over the ~5.9M decoder weights, 23.6 MB in float32), and every group
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

extern "C" {

// Floats of workspace the launch needs (zero-filled by the caller).
int64_t wr_taco_decode_work_floats(const DecodeArgs* args) {
  return Work(nullptr, *args).size;
}

// Launches the decode on `stream`; returns the CUDA error code (0 = launched).
int wr_taco_decode(const DecodeArgs* args, void* stream) {
  const void* fn = (const void*)taco_decode;
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
  DecodeArgs a = *args;
  void* kargs[] = {&a};
  e = cudaLaunchCooperativeKernel(fn, dim3(sms), dim3(THREADS), kargs, smem,
                                  (cudaStream_t)stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // extern "C"
