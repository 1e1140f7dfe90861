// Tacotron teacher-forcing decoder recurrence (B6) for Hopper (sm_90a),
// redesigned around the card: taco_tf_res_fwd / taco_tf_res_bwd, one
// cooperative launch per direction, one block per SM, 256 threads. Every TF
// launch runs here (the TF training step, the AF-online teacher's eval
// forward, --force_gta and --force_attn); csrc/taco_train.cu's TF arm
// (taco_tf_fwd / taco_tf_bwd) is the yardstick, reached only through the
// wrappers' private _legacy=True.
//
// Replaces: wavernn_tpu/ops/pallas_taco_train.py, _make_fwd_kernel(af=False)
// (:80, called at :328 through _fwd_impl, via _core :643) and
// _make_bwd_kernel(af=False) (:350, called at :747 through _core_bwd
// :666). ops/cuda_taco_train.py holds the wrappers, the launch plan
// (tf_resident_plan) and the plain versions (core_ref, core_bwd_ref).
//
// What it computes is taco_train.cu's TF arm (its head note has the
// equations), with the same inputs, outputs and saved streams (STREAMS): a
// forward of either body feeds a backward of either. This file includes
// taco_train_resident.cu (and through it taco_train.cu) for their structs,
// device helpers and reductions, with TACO_TRAIN_HELPERS_ONLY set so that
// neither file's kernels are compiled again here.
//
// What bounds it. At B 32, T_text 150, 100 groups (r 7) the forward is about
// 50 GFLOP (0.74 ms at 67 TF/s float32), the backward 114 GFLOP (1.7 ms);
// neither is near: the limit is the chain of dependent groups. The original
// body runs five grid barriers a group in one line (GRU, attention on one
// block per utterance, rnn_input, LSTM1, LSTM2; the mel in the next group's
// first interval), and its attention stage runs on 32 of 132 SMs.
//
// Design, against that:
//  1. Two chains. In teacher forcing the prenet reads the ground-truth frame
//     (hoisted), so nothing in the recurrence reads the mel. The attention
//     chain GRU([ctx | pre], ah) -> query -> energies -> normaliser ->
//     context feeds itself; the mel chain rnn_input([ctx | ah]) -> LSTM1 ->
//     LSTM2 -> mel consumes (ctx_g, ah_g) and feeds nothing back.
//     Forward: three split-barrier intervals a group; in each the attention
//     chain runs group g and the mel chain group g - 1: (GRU_g with
//     rnn_input_{g-1}, both reading [ctx_{g-1} | ah_{g-1}]), (query_g with
//     LSTM1_{g-1}), (the attention items of g with LSTM2_{g-1}). The pre
//     half of the GRU's input product (pre @ awi[:, E:]^T + abi, all G * B
//     rows) is one product before the first group, mel = x2 wm^T one
//     product after the last.
//     Backward: the mel chain's backward (LSTM2's cell, then dG2 @ l2w,
//     LSTM1's cell, dG1 @ l1w, dx0 @ wr) needs no cotangent of the attention
//     chain, so it runs two groups ahead and hands over (dx0 @ wr) for ctx
//     and ah through per-group buffers; dx2 = dmel @ wm is one product
//     before the first group. The attention chain keeps three intervals a
//     group: the GRU's backward on [dq_g | dgh_{g+1}] (dah = dtz + dgh_{g+1}
//     awh + the rnn_input part + dq wq), then the items' phase A of g - 1
//     (d(scores) with the context cotangent's contraction: dctx_t . enc_t =
//     rnn part . enc_t + dgi_g . (enc_t awi[:, :E]^T), the second factor one
//     product before the first group, so no stage waits for d(ctx)), then
//     phase B (energies, d(q)). d(ctx) itself (dgi awi[:, :E]), d(pre) (dgi
//     awi[:, E:]) and d(enc) (sum over groups of s dctx_t) are products
//     after the last group.
//  2. The attention runs on every block, in items of 16 text positions of
//     one utterance (B * ceil(T / 16) items, item i on block i mod grid),
//     each the original's chunk code for the energies. A forward item also
//     forms its partial normaliser and its partial context sum_t sig_t
//     enc_t; the last item of an utterance to arrive (an atomic count per
//     utterance) sums the partials in item order, so the result does not
//     depend on who arrives last, and writes the context, the scores and
//     the next cumulative. Backward phase B's last item sums d(q) likewise.
//     The items are latency-bound on eight warps: each issues the loads of
//     its own operands (its encp rows, windows, carries, d(encp), phase
//     A's rows of enc and enc awi[:, :E]^T) before its first block barrier,
//     so their round trips overlap; phase B forms the location weight's
//     gradient four taps at a time from register windows and the conv's
//     input cotangents with 16-byte shared loads.
//  3. Matrix stages as in the B7 body (taco_train_resident.cu's kstage):
//     unit j of a stage on block j mod grid, the LSTMs' rows resident in
//     shared memory by cp.async.bulk where the plan has room, inputs staged
//     a chunk of columns at a time by cp.async on all eight warps, dot
//     products in the original's order.
//  4. A split counter barrier (res::Bar), as B7's.
// Not used: tensor cores (float32, no TF32: the gradients are held to
// 1e-4), clusters, tagged words.
#define TACO_TRAIN_HELPERS_ONLY 1
#include "taco_train_resident.cu"

namespace tfres {

using res::Bar;
using res::Prof;
using res::pair_at;
using res::u64;

// C[m, n] = (acc ? C[m, n] : 0) + bias[n] + sum_k A[m sam + k sak] W[n swn
// + k swk] (bias may be null): 64 x 64 tiles, 16 values of k a pass through
// shared memory, each thread a 4 x 4 block, a fixed order.
// (SA, SW, SC: the operands' and the product's storage types; float, or
// bf16 for the bf16 instantiations' weights and streams.)
template <typename SA, typename SW, typename SC>
struct GemmT {
  const SA* A;
  int64_t sam, sak;
  const SW* W;
  int64_t swn, swk;
  const float* bias;
  SC* C;
  int64_t ldc, M, N, K, acc;
};
using Gemm = GemmT<float, float, float>;

template <typename G_>
__device__ __forceinline__ int64_t gemm_tiles(const G_& g) {
  return g.M > 0 && g.N > 0 ? ((g.M + 63) / 64) * ((g.N + 63) / 64) : 0;
}

// One tile (sm: 2 x 16 x 64 floats). Operands read through L2: other blocks
// may have written them in this launch.
template <typename G_>
__device__ __forceinline__ void gemm_tile(const G_& g, int64_t tile, float* sm) {
  float* As = sm;             // [16][64]
  float* Ws = sm + 16 * 64;   // [16][64]
  const int64_t tn = (g.N + 63) / 64;
  const int64_t m0 = tile / tn * 64, n0 = tile % tn * 64;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int64_t k0 = 0; k0 < g.K; k0 += 16) {
    __syncthreads();
    for (int e = threadIdx.x; e < 16 * 64; e += THREADS) {
      // the faster index on the operand's unit stride
      const int ka = g.sak == 1 ? (e & 15) : (e >> 6), ma = g.sak == 1 ? (e >> 4) : (e & 63);
      const int64_t m = m0 + ma, k = k0 + ka;
      As[ka * 64 + ma] = (m < g.M && k < g.K) ? ldcgv(g.A + m * g.sam + k * g.sak) : 0.f;
      const int kw = g.swk == 1 ? (e & 15) : (e >> 6), nw = g.swk == 1 ? (e >> 4) : (e & 63);
      const int64_t n = n0 + nw, k2 = k0 + kw;
      Ws[kw * 64 + nw] = (n < g.N && k2 < g.K) ? ldcgv(g.W + n * g.swn + k2 * g.swk) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = As[k * 64 + ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Ws[k * 64 + tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t m = m0 + ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t n = n0 + tx * 4 + j;
      if (m < g.M && n < g.N) {
        float v = acc[i][j];
        if (g.bias) v += g.bias[n];
        auto* c = g.C + m * g.ldc + n;
        stv(c, g.acc ? ldcgv(c) + v : v);
      }
    }
  }
}

// Two products' tiles over the grid, block k taking tiles k, k + grid, ...
template <typename G1, typename G2>
__device__ __forceinline__ void gemm2(const G1& g1, const G2& g2, int nblk, float* sm) {
  const int64_t t1 = gemm_tiles(g1), t2 = gemm_tiles(g2);
  for (int64_t t = blockIdx.x; t < t1 + t2; t += nblk) {
    if (t < t1)
      gemm_tile(g1, t, sm);
    else
      gemm_tile(g2, t - t1, sm);
  }
  __syncthreads();
}

// sum_k src[k * stride] for k < n in order, eight loads in flight
__device__ __forceinline__ float strided_sum(const float* src, int n, size_t stride) {
  float s = 0.f;
  for (int k0 = 0; k0 < n; k0 += 8) {
    float v[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) v[q] = k0 + q < n ? __ldcg(src + (size_t)(k0 + q) * stride) : 0.f;
#pragma unroll
    for (int q = 0; q < 8; ++q)
      if (k0 + q < n) s += v[q];
  }
  return s;
}

// An item's arrival at its utterance's count (all threads): true, on every
// thread, for the last of the utterance's `nc` items of round `round`
// (rounds counted from 0); its reads of the others' partials then follow.
__device__ __forceinline__ bool last_of_utterance(unsigned* cnt, int nc, int round, float* flag) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    const unsigned old = atomicAdd(cnt, 1u);
    const bool last = old == (unsigned)((round + 1) * nc - 1);
    if (last) __threadfence();
    *flag = last ? 1.f : 0.f;
  }
  __syncthreads();
  return *flag != 0.f;
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

// (S as in fwd: the bf16 instantiation keeps x2 of every group in floats
// for the mel product, beside the bf16 s_x2 stream.)
template <typename S>
struct TWork {
  float *ah[2], *h1[2], *c1[2], *h2[2], *c2[2], *x0, *x1, *q, *ctx, *cum, *sig;
  float *pdiv, *pctx, *gpre, *x2all;
  unsigned* cnt;
  u64* bar;
  int64_t size;
  __host__ __device__ TWork(float* w, const TfFwdArgs& a, const ResPlan& p) {
    Take take{w};
    const int64_t B = a.B;
    for (int i = 0; i < 2; ++i) {
      ah[i] = take(B * a.D);
      h1[i] = take(B * a.L); c1[i] = take(B * a.L);
      h2[i] = take(B * a.L); c2[i] = take(B * a.L);
    }
    x0 = take(B * a.L); x1 = take(B * a.L);
    q = take(B * a.D); ctx = take(B * a.E); cum = take(B * a.T); sig = take(B * a.T);
    pdiv = take(B * p.nc); pctx = take(B * p.nc * a.E);
    gpre = take(a.G * B * 3 * a.D);
    x2all = a.save && std::is_same<S, float>::value ? nullptr : take(a.G * B * a.L);
    cnt = reinterpret_cast<unsigned*>(take(B));
    bar = reinterpret_cast<u64*>(take(4));
    size = take.size;
  }
};

// lsa_args (taco_train.cu) with the item's encp values of unit d already
// in registers (ep[tt], positions t0 + tt): the same sums.
template <typename W>
__device__ __forceinline__ void lsa_args_pre(float (&arg)[TC], const float (&ep)[TC], int tc,
                                             int d, int D, float qd, const float* cumw,
                                             const float* attw, const W* w01t) {
#pragma unroll
  for (int h = 0; h < TC / TH; ++h) {
    const int tb = h * TH;
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
      arg[tb + j] = tb + j < tc ? tanhf((loc[j] + ep[tb + j]) + qd) : 0.f;
  }
}

// forward profile labels (cycles summed over groups, block 0); from
// counter 16 on, the split of block 0's items
enum TFProf { TF_PRO, TF_GRU, TF_RNN, TF_W1, TF_Q, TF_L1, TF_W2, TF_ITEMS, TF_L2, TF_W3, TF_MEL };
enum TFItemProf { TF_I_WINDOWS = 16, TF_I_ENERGIES, TF_I_PARTIALS, TF_I_REDUCTION };

// One forward attention item: positions [16c, 16c + tc) of utterance b at
// group g. Its window of the cumulative (entering g) and the previous
// attention (the scores of g - 1), the original's chunk code for the
// energies, the unnormalised sigmoids, their partial sum and the partial
// context sum_t sig_t enc_t. The utterance's last item to arrive sums the
// partials in item order: the normaliser, ctx_g = sum / div, the scores of
// g and the cumulative entering g + 1.
// (bf16: the scores are rounded to bf16 before the cumulative and the
// context take them, so the last item forms ctx_g = sum_t s_t enc_t itself
// from the rounded scores, and the items form no partial contexts.)
template <typename S>
__device__ __forceinline__ void att_item(const TfFwdArgs& a, const TWork<S>& w, const S* s_w01t,
                                         float* sc, int nc, int b, int c, int g, long long* sub) {
  constexpr bool BF = !std::is_same<S, float>::value;
  const int B = (int)a.B, T = (int)a.T, D = (int)a.D, E = (int)a.E;
  const int t0 = c * TC, tc = min(TC, T - t0);
  const bool save = a.save != 0;
  float* cw = sc;
  float* aw = cw + res::WINP;
  float* red16 = aw + res::WINP;
  float* su = red16 + WARPS * TC;
  float* misc = su + TC;
  float* part = misc + 16;
  Prof ps;   // the item's own split (the profiling instantiation)
  ps.start(sub);
  const int d = threadIdx.x;
  const bool unit = d < D;
  const float qd = unit ? __ldcg(w.q + (size_t)b * D + d) : 0.f;
  const float vd = unit ? ldv(cs<S>(a.v) + d) : 0.f;
  float ep[TC];
#pragma unroll
  for (int tt = 0; tt < TC; ++tt)
    ep[tt] = unit && tt < tc ? ldv(cs<S>(a.encp) + (((size_t)b * T + t0 + tt) * D + d)) : 0.f;
  __syncthreads();
  if (threadIdx.x < res::WINP) {
    const int j = threadIdx.x, t = t0 - CONV_HALF + j;
    const bool in = j < res::WIN && t >= 0 && t < T;
    const float cu = in ? __ldcg(w.cum + (size_t)b * T + t) : 0.f;
    cw[j] = cu;
    aw[j] = in && g > 0 ? __ldcg(a.scores + ((size_t)(g - 1) * B + b) * T + t) : 0.f;
    if (save && j >= CONV_HALF && j < CONV_HALF + tc) a.s_cum[((size_t)g * B + b) * T + t] = cu;
  }
  __syncthreads();
  ps.stamp(TF_I_WINDOWS);
  float arg[TC];
  if (unit) {
    lsa_args_pre(arg, ep, tc, d, D, qd, cw, aw, s_w01t);
  } else {
#pragma unroll
    for (int tt = 0; tt < TC; ++tt) arg[tt] = 0.f;
  }
  lsa_u(arg, vd, red16, su);
  if (threadIdx.x < tc) {
    const float sig = sigm(su[threadIdx.x]);
    w.sig[(size_t)b * T + t0 + threadIdx.x] = sig;
    su[threadIdx.x] = sig;
  }
  __syncthreads();
  ps.stamp(TF_I_ENERGIES);
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int tt = 0; tt < tc; ++tt) s += su[tt];
    w.pdiv[(size_t)b * nc + c] = s;
  }
  if constexpr (!BF) {
    const float* en = a.enc + ((size_t)b * T + t0) * E;
    for (int e = threadIdx.x; e < E; e += THREADS) {
      float s = 0.f;
      for (int tt = 0; tt < tc; ++tt) s = fmaf(su[tt], __ldg(en + (size_t)tt * E + e), s);
      w.pctx[((size_t)b * nc + c) * E + e] = s;
    }
  }
  const bool last = last_of_utterance(w.cnt + b, nc, g, misc + 1);
  ps.stamp(TF_I_PARTIALS);
  if (!last) return;
  for (int k = threadIdx.x; k < nc; k += THREADS) part[k] = __ldcg(w.pdiv + (size_t)b * nc + k);
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int k = 0; k < nc; ++k) s += part[k];
    misc[0] = s;
  }
  __syncthreads();
  const float div = misc[0], dv = div > 0.f ? div : 1.f;
  if constexpr (BF) {
    float* srow = a.scores + ((size_t)g * B + b) * T;
    for (int t = threadIdx.x; t < T; t += THREADS) {
      const float s = rnd<S>(__ldcg(w.sig + (size_t)b * T + t) / dv);
      srow[t] = s;
      w.cum[(size_t)b * T + t] = __ldcg(w.cum + (size_t)b * T + t) + s;
    }
    __syncthreads();
    const S* en = cs<S>(a.enc) + (size_t)b * T * E;
    for (int e = threadIdx.x; e < E; e += THREADS) {
      float cx = 0.f;
      for (int t = 0; t < T; ++t) cx = fmaf(__ldcg(srow + t), ldgv(en + (size_t)t * E + e), cx);
      cx = rnd<S>(cx);
      w.ctx[(size_t)b * E + e] = cx;
      if (save) stv(ms<S>(a.s_ctx) + ((size_t)g * B + b) * E + e, cx);
    }
  } else {
    for (int e = threadIdx.x; e < E; e += THREADS) {
      const float cx = strided_sum(w.pctx + (size_t)b * nc * E + e, nc, (size_t)E) / dv;
      w.ctx[(size_t)b * E + e] = cx;
      if (save) a.s_ctx[((size_t)g * B + b) * E + e] = cx;
    }
    for (int t = threadIdx.x; t < T; t += THREADS) {
      const float s = __ldcg(w.sig + (size_t)b * T + t) / dv;
      a.scores[((size_t)g * B + b) * T + t] = s;
      w.cum[(size_t)b * T + t] = __ldcg(w.cum + (size_t)b * T + t) + s;
    }
  }
  if (threadIdx.x == 0 && save) a.s_div[(size_t)g * B + b] = div;
  ps.stamp(TF_I_REDUCTION);
}


// S: the storage type of the weights, the streams, the saved states and the
// mel (float, or bf16 in taco_tf_res_*_bf16); rnd<S> rounds where the JAX
// kernel rounds to its compute dtype (ah, the scores, ctx, x0, c, h, x1,
// x2, the mel).
template <bool PROF, typename S>
__device__ __forceinline__ void fwd(const TfFwdArgs& a, const ResPlan& p, long long* prof_out) {
  constexpr bool BF = !std::is_same<S, float>::value;
  const int G = (int)a.G, B = (int)a.B, E = (int)a.E, D = (int)a.D;
  const int P2 = (int)a.P2, L = (int)a.L, F = (int)a.F;
  const int nblk = (int)p.nblk, nc = (int)p.nc, ipb = (int)p.ipb;
  const bool save = a.save != 0;
  const int lane = threadIdx.x & 31;
  TWork<S> wk(a.work, a, p);
  Bar bar{wk.bar, (u64)nblk, 0};
  Prof pf;
  pf.start(PROF ? prof_out : nullptr);

  extern __shared__ float smem[];
  uint64_t* mbar = reinterpret_cast<uint64_t*>(smem);
  S* s_w01t = ms<S>(smem + p.off_w01t);
  float* s_att = smem + p.off_att;
  float* X = smem + p.off_x;
  S* s_l1 = ms<S>(smem + p.off_l1);
  S* s_l2 = ms<S>(smem + p.off_l2);
  float* x2all = save && !BF ? a.s_x2 : wk.x2all;

  // ---- prologue: the GRU's input product on pre for every group (shared
  // memory as the tiles' scratch), then the resident LSTM rows, the
  // location weight
  {
    const GemmT<S, S, float> pre{cs<S>(a.pre), P2, 1, cs<S>(a.awi) + E, E + P2, 1, a.abi,
                                 wk.gpre, 3 * D, (int64_t)G * B, 3 * D, P2, 0};
    const GemmT<S, S, float> none{nullptr, 0, 0, nullptr, 0, 0, nullptr, nullptr, 0, 0, 0, 0, 0};
    gemm2(pre, none, nblk, smem + 4);
  }
  const int mine_l = (int)blockIdx.x < L ? (L - 1 - (int)blockIdx.x) / nblk + 1 : 0;
  const uint32_t row_bytes = (uint32_t)L * (uint32_t)sizeof(S);
  const uint32_t res_bytes = (uint32_t)((p.res_l1 + p.res_l2) * mine_l * 8) * row_bytes;
  if (threadIdx.x == 0) {
    res::mbar_init(mbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0 && res_bytes) {
    res::mbar_expect_tx(mbar, res_bytes);
    for (int layer = 0; layer < 2; ++layer) {
      if (!(layer == 0 ? p.res_l1 : p.res_l2)) continue;
      const S* wi = cs<S>(layer == 0 ? a.l1wi : a.l2wi);
      const S* wh = cs<S>(layer == 0 ? a.l1wh : a.l2wh);
      S* dst = layer == 0 ? s_l1 : s_l2;
      for (int m = 0; m < mine_l; ++m) {
        const int j = (int)blockIdx.x + m * nblk;
        for (int g4 = 0; g4 < 4; ++g4) {
          S* row = dst + ((size_t)m * 4 + g4) * 2 * L;
          res::bulk_g2s(row, wi + ((size_t)g4 * L + j) * L, row_bytes, mbar);
          res::bulk_g2s(row + L, wh + ((size_t)g4 * L + j) * L, row_bytes, mbar);
        }
      }
    }
  }
  for (int e = threadIdx.x; e < NTAP * D; e += THREADS) s_w01t[e] = cs<S>(a.w01t)[e];
  if (res_bytes) res::mbar_wait(mbar, 0);
  __syncthreads();
  bar.sync();
  pf.stamp(TF_PRO);

  // LSTM `layer` (0, 1) of group gl: the residual LSTMCell with zoneout on h
  auto lstm = [&](int layer, int gl) {
    const size_t gb = (size_t)gl * B;
    const int in = (gl + 1) & 1, out = gl & 1;
    const S* wi = cs<S>(layer == 0 ? a.l1wi : a.l2wi);
    const S* wh = cs<S>(layer == 0 ? a.l1wh : a.l2wh);
    const S* sw = layer == 0 ? s_l1 : s_l2;
    const bool resident = (layer == 0 ? p.res_l1 : p.res_l2) != 0;
    const float* bias = layer == 0 ? a.l1b : a.l2b;
    const S* zm = cs<S>(layer == 0 ? a.zm1 : a.zm2) + gb * L;
    const float* xin = layer == 0 ? wk.x0 : wk.x1;
    float* xout = layer == 0 ? wk.x1 : x2all + gb * L;
    const float* h_cur = layer == 0 ? pair_at(wk.h1, in) : pair_at(wk.h2, in);
    const float* c_cur = layer == 0 ? pair_at(wk.c1, in) : pair_at(wk.c2, in);
    float* h_nxt = layer == 0 ? pair_at(wk.h1, out) : pair_at(wk.h2, out);
    float* c_nxt = layer == 0 ? pair_at(wk.c1, out) : pair_at(wk.c2, out);
    S* s_gates = ms<S>(layer == 0 ? a.s_g1 : a.s_g2);
    S* s_c = ms<S>(layer == 0 ? a.s_c1 : a.s_c2);
    S* s_h = ms<S>(layer == 0 ? a.s_h1 : a.s_h2);
    const Seg segs[2] = {{xin, L, L}, {h_cur, L, L}};
    res::kstage<4, 1, 2>(
        p, X, B, L, segs, 2,
        [&](float(&acc)[1][4][RB], int j, int m, const float* Xt, int kcs, int c0, int c1,
            int nr) {
          if (resident) {
            const S* rows = sw + (size_t)m * 4 * 2 * L;
            res::kdots<4, true>(acc[0], rows, 2 * (size_t)L, L, 0, Xt, kcs, c0, c1, nr);
            res::kdots<4, true>(acc[0], rows + L, 2 * (size_t)L, L, L, Xt, kcs, c0, c1, nr);
          } else {
            res::kdots<4, false>(acc[0], wi + (size_t)j * L, (size_t)L * L, L, 0, Xt, kcs, c0, c1,
                                 nr);
            res::kdots<4, false>(acc[0], wh + (size_t)j * L, (size_t)L * L, L, L, Xt, kcs, c0, c1,
                                 nr);
          }
        },
        [&](float(&acc)[1][4][RB], int j, int, int b0, int nr) {
          if (lane < nr) {
            const int b = b0 + lane;
            const size_t o = (size_t)b * L + j;
            const float ig = sigm(pick(acc[0][0], lane) + bias[j]);
            const float fg = sigm(pick(acc[0][1], lane) + bias[L + j]);
            const float gg = tanhf(pick(acc[0][2], lane) + bias[2 * L + j]);
            const float og = sigm(pick(acc[0][3], lane) + bias[3 * L + j]);
            const float c = rnd<S>(fg * __ldcg(c_cur + o) + ig * gg);
            const float hp = __ldcg(h_cur + o);
            const float zz = ldv(zm + o);
            const float h = rnd<S>(zz * hp + (1.f - zz) * (og * tanhf(c)));
            const float xv = rnd<S>(__ldcg(xin + o) + h);
            c_nxt[o] = c;
            h_nxt[o] = h;
            xout[o] = xv;
            if (save) {
              const size_t so = (gb + b) * L + j;
              S* sg = s_gates + (gb + b) * 4 * L;
              stv(sg + j, ig);
              stv(sg + (L + j), fg);
              stv(sg + (2 * L + j), gg);
              stv(sg + (3 * L + j), og);
              stv(s_c + so, c);
              stv(s_h + so, h);
              if (layer == 0) stv(ms<S>(a.s_x1) + so, xv);
              if constexpr (BF)
                if (layer == 1) stv(ms<S>(a.s_x2) + so, xv);
            }
          }
        });
  };

  for (int g = 0; g <= G; ++g) {
    const size_t gb = (size_t)g * B;
    const int in = (g + 1) & 1, out = g & 1;
    // ---- interval 1: GRU_g on [ctx_{g-1} | ah_{g-1}] (its pre half from
    // the prologue); rnn_input_{g-1} on the same ----
    const Seg segs1[2] = {{g > 0 ? wk.ctx : nullptr, E, E}, {pair_at(wk.ah, in), D, D}};
    if (g < G) {
      res::kstage<3, 2, 1>(
          p, X, B, D, segs1, 2,
          [&](float(&acc)[2][3][RB], int j, int, const float* Xt, int kcs, int c0, int c1,
              int nr) {
            res::kdots<3, false>(acc[0], cs<S>(a.awi) + (size_t)j * (E + P2),
                                 (size_t)D * (E + P2), E, 0, Xt, kcs, c0, c1, nr);
            res::kdots<3, false>(acc[1], cs<S>(a.awh) + (size_t)j * D, (size_t)D * D, D, E, Xt,
                                 kcs, c0, c1, nr);
          },
          [&](float(&acc)[2][3][RB], int j, int, int b0, int nr) {
            if (lane < nr) {
              const int b = b0 + lane;
              const float(&gi)[3][RB] = acc[0];
              const float(&gh)[3][RB] = acc[1];
              const float* gp = wk.gpre + (gb + b) * 3 * D;
              const float r =
                  sigm((pick(gi[0], lane) + __ldcg(gp + j)) + (pick(gh[0], lane) + a.abh[j]));
              const float z = sigm((pick(gi[1], lane) + __ldcg(gp + D + j)) +
                                   (pick(gh[1], lane) + a.abh[D + j]));
              const float hn = pick(gh[2], lane) + a.abh[2 * D + j];
              const float n = tanhf((pick(gi[2], lane) + __ldcg(gp + 2 * D + j)) + r * hn);
              const float hp = __ldcg(pair_at(wk.ah, in) + (size_t)b * D + j);
              const float h = rnd<S>((1.f - z) * n + z * hp);
              pair_at(wk.ah, out)[(size_t)b * D + j] = h;
              if (save) {
                stv(ms<S>(a.s_ah) + ((gb + b) * D + j), h);
                S* s = ms<S>(a.s_gru) + (gb + b) * 4 * D;
                stv(s + j, r);
                stv(s + (D + j), z);
                stv(s + (2 * D + j), n);
                stv(s + (3 * D + j), hn);
              }
            }
          });
    }
    pf.stamp(TF_GRU);
    if (g > 0) {
      const size_t gp = gb - B;
      res::kstage<1, 1, 2>(
          p, X, B, L, segs1, 2,
          [&](float(&acc)[1][1][RB], int u, int, const float* Xt, int kcs, int c0, int c1,
              int nr) {
            res::kdots<1, false>(acc[0], cs<S>(a.wr) + (size_t)u * (E + D), 0, E + D, 0, Xt, kcs,
                                 c0, c1, nr);
          },
          [&](float(&acc)[1][1][RB], int u, int, int b0, int nr) {
            if (lane < nr) {
              const int b = b0 + lane;
              const float x0 = rnd<S>(pick(acc[0][0], lane) + a.br[u]);
              wk.x0[(size_t)b * L + u] = x0;
              if (save) stv(ms<S>(a.s_x0) + ((gp + b) * L + u), x0);
            }
          });
    }
    pf.stamp(TF_RNN);
    bar.sync();
    pf.stamp(TF_W1);
    // ---- interval 2: the query of g; LSTM1 of g - 1 ----
    if (g < G) {
      const Seg segs[1] = {{pair_at(wk.ah, out), D, D}};
      res::kstage<1, 1, 1>(
          p, X, B, D, segs, 1,
          [&](float(&acc)[1][1][RB], int u, int, const float* Xt, int kcs, int c0, int c1,
              int nr) {
            res::kdots<1, false>(acc[0], cs<S>(a.wq) + (size_t)u * D, 0, D, 0, Xt, kcs, c0, c1,
                                 nr);
          },
          [&](float(&acc)[1][1][RB], int u, int, int b0, int nr) {
            if (lane < nr) {
              const int b = b0 + lane;
              const float qv = a.qb[u] + pick(acc[0][0], lane);
              wk.q[(size_t)b * D + u] = qv;
              if (save) a.s_q[(gb + b) * D + u] = qv;
            }
          });
    }
    pf.stamp(TF_Q);
    if (g > 0) lstm(0, g - 1);
    pf.stamp(TF_L1);
    bar.sync();
    pf.stamp(TF_W2);
    // ---- interval 3: the attention items of g; LSTM2 of g - 1 ----
    if (g < G) {
      for (int m = 0; m < ipb; ++m) {
        const int it = (int)blockIdx.x + m * nblk;
        if (it >= B * nc) break;
        att_item(a, wk, s_w01t, s_att, nc, it / nc, it % nc, g, PROF ? prof_out : nullptr);
      }
    }
    pf.stamp(TF_ITEMS);
    if (g > 0) lstm(1, g - 1);
    pf.stamp(TF_L2);
    bar.sync();
    pf.stamp(TF_W3);
  }
  // ---- epilogue: mel = x2 wm^T for every group ----
  {
    const GemmT<float, S, S> mel{x2all, L, 1, cs<S>(a.wm), L, 1, nullptr, ms<S>(a.mel), F,
                                 (int64_t)G * B, F, L, 0};
    const GemmT<float, S, S> none{nullptr, 0, 0, nullptr, 0, 0, nullptr, nullptr, 0, 0, 0, 0, 0};
    gemm2(mel, none, nblk, smem + 4);
  }
  pf.stamp(TF_MEL);
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

// backward profile labels (cycles summed over groups, block 0); from
// counter 16 on, the split of block 0's items
enum TBProf { TB_PRO, TB_GRU, TB_M2, TB_W1, TB_A, TB_M1, TB_W2, TB_B, TB_R, TB_W3, TB_EPI };
enum TBItemProf {
  TB_A_LOAD = 16, TB_A_CONTRACTION, TB_A_DS, TB_B_SUM_WINDOWS, TB_B_ENERGIES, TB_B_DP_DENCP,
  TB_B_W01_GRAD, TB_B_CONV_COTANGENTS, TB_B_CONTRIB, TB_B_DQ
};

// The B7 body's backward work (its carries, item buffers and barrier; its
// dctxt holds the rnn_input part of d(ctx) of every group, then d(ctx)
// entire), then the TF arm's own: dx2 = dmel @ wm of every group, enc's
// rows through awi[:, :E]^T, the rnn_input part of d(ah) of every group,
// the per-utterance arrival counts.
struct TBWork {
  res::BWork w;
  float *dx2all, *encw, *rah;
  unsigned* cnt;
  int64_t size;
  __host__ __device__ TBWork(float* p0, const TfBwdArgs& a, const ResPlan& p) : w(p0, a, p) {
    Take take{p0 ? p0 + w.size : nullptr};
    dx2all = take(a.G * a.B * a.L);
    encw = take(a.B * a.T * 3 * a.D);
    rah = take(a.G * a.B * a.D);
    cnt = reinterpret_cast<unsigned*>(take(a.B));
    size = w.size + take.size;
  }
};

// Phase A of a backward item (b, c) at group g: the context cotangent's
// contraction dctx_t . enc_t at its positions (the rnn_input part against
// enc_t, d(gi) of group g + 1 against enc_t awi[:, :E]^T), then B7's phase
// A: d(scores) from the scores' cotangent, the carries and the location
// conv's input cotangents of group g + 1, and the partial of S.
template <typename S>
__device__ __forceinline__ void att_a(const TfBwdArgs& a, const TBWork& wk, float* sc, int G,
                                      int nc, int b, int c, int g, long long* sub) {
  const res::BWork& w = wk.w;
  const int B = (int)a.B, T = (int)a.T, E = (int)a.E, D3 = 3 * (int)a.D;
  const int t0 = c * TC, tc = min(TC, T - t0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool nxt = g + 1 < G;
  float* prt = sc;           // TC
  float* con = sc + 16;      // TC
  float* s_rc = sc + 32;     // E
  float* s_dg = s_rc + up4(E);   // 3D
  Prof ps;
  ps.start(sub);
  // the position's carries and inputs (thread tt < tc), in flight beside
  // the row loads below: the location conv's input cotangents of group g +
  // 1 from the item and its neighbours, d(cumulative), d(scores), scores
  float vc[3], va[3], dcum0 = 0.f, dsc0 = 0.f, sc0 = 0.f;
  {
    const int t = t0 + threadIdx.x;
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      const int c2 = c - 1 + q, j = t - (c2 * TC - CONV_HALF);
      const bool ok = threadIdx.x < tc && g < G - 1 && c2 >= 0 && c2 < nc && j >= 0 &&
                      j < res::WIN;
      const float* cb = w.contrib + ((size_t)b * nc + c2) * 2 * res::WINP;
      vc[q] = ok ? __ldcg(cb + j) : 0.f;
      va[q] = ok ? __ldcg(cb + res::WINP + j) : 0.f;
    }
    if (threadIdx.x < tc) {
      const size_t o = ((size_t)g * B + b) * T + t;
      dcum0 = __ldcg(w.dcum + (size_t)b * T + t);
      dsc0 = a.dsc[o];
      sc0 = a.scores[o];
    }
  }
  // a warp per two positions (tt = warp, warp + 8), lanes along the row
  // by 16-byte loads: the rows' loads are issued first, for both
  // positions at once, so they overlap the operands' own loads below
  constexpr int RE = 2, RK = 6;   // float4s a lane holds: E <= 256, 3D <= 768
  const bool fits = E <= 128 * RE && D3 <= 128 * RK;
  float4 xe[2][RE], xk[2][RK];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int tt = warp + h * WARPS;
    const size_t bt = (size_t)b * T + t0 + tt;
#pragma unroll
    for (int i = 0; i < RE; ++i) {
      const int e = lane + 32 * i;
      xe[h][i] = fits && tt < tc && e < E / 4 ? ldg4i(cs<S>(a.enc) + bt * E, e)
                                              : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int i = 0; i < RK; ++i) {
      const int k = lane + 32 * i;
      xk[h][i] = fits && nxt && tt < tc && k < D3 / 4
                     ? __ldcg(reinterpret_cast<const float4*>(wk.encw + bt * D3) + k)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < E; e += THREADS)
    s_rc[e] = __ldcg(w.dctxt + ((size_t)g * B + b) * E + e);
  if (nxt)
    for (int k = threadIdx.x; k < D3; k += THREADS)
      s_dg[k] = __ldcg(a.c_dgi + ((size_t)(g + 1) * B + b) * D3 + k);
  __syncthreads();
  ps.stamp(TB_A_LOAD);
  const float4* rc = reinterpret_cast<const float4*>(s_rc);
  const float4* dg = reinterpret_cast<const float4*>(s_dg);
  if (fits) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int tt = warp + h * WARPS;
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < RE; ++i) {
        const int e = lane + 32 * i;
        if (e < E / 4) {
          const float4 x = xe[h][i], y = rc[e];
          acc = fmaf(y.x, x.x, fmaf(y.y, x.y, fmaf(y.z, x.z, fmaf(y.w, x.w, acc))));
        }
      }
#pragma unroll
      for (int i = 0; i < RK; ++i) {
        const int k = lane + 32 * i;
        if (nxt && k < D3 / 4) {
          const float4 x = xk[h][i], y = dg[k];
          acc = fmaf(y.x, x.x, fmaf(y.y, x.y, fmaf(y.z, x.z, fmaf(y.w, x.w, acc))));
        }
      }
      acc = warp_sum(acc);
      if (lane == 0 && tt < tc) con[tt] = acc;
    }
  } else {
    // wider rows: the row loads in the loop
    for (int tt = warp; tt < tc; tt += WARPS) {
      const size_t bt = (size_t)b * T + t0 + tt;
      float acc = 0.f;
      const S* er = cs<S>(a.enc) + bt * E;
#pragma unroll 4
      for (int e = lane; e < E / 4; e += 32) {
        const float4 x = ldg4i(er, e), y = rc[e];
        acc = fmaf(y.x, x.x, fmaf(y.y, x.y, fmaf(y.z, x.z, fmaf(y.w, x.w, acc))));
      }
      if (nxt) {
        const float4* ew = reinterpret_cast<const float4*>(wk.encw + bt * D3);
#pragma unroll 8
        for (int k = lane; k < D3 / 4; k += 32) {
          const float4 x = __ldcg(ew + k), y = dg[k];
          acc = fmaf(y.x, x.x, fmaf(y.y, x.y, fmaf(y.z, x.z, fmaf(y.w, x.w, acc))));
        }
      }
      acc = warp_sum(acc);
      if (lane == 0) con[tt] = acc;
    }
  }
  __syncthreads();
  ps.stamp(TB_A_CONTRACTION);
  if (threadIdx.x < tc) {
    const float lc = (vc[0] + vc[1]) + vc[2], la = (va[0] + va[1]) + va[2];
    const size_t bt = (size_t)b * T + t0 + threadIdx.x;
    const float dcum = dcum0 + lc;
    w.dcum[bt] = dcum;
    const float ds = dsc0 + dcum + la + con[threadIdx.x];
    w.dsb[bt] = ds;
    prt[threadIdx.x] = ds * sc0;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int tt = 0; tt < tc; ++tt) s += prt[tt];
    w.spart[(size_t)b * nc + c] = s;
  }
  ps.stamp(TB_A_DS);
}

// The location conv's input cotangents over an item's window (the B7
// body's loc_grads with 16-byte loads along d): P[tt][k] = sum_d dp[tt][d]
// w01t[k][d] for the 62 taps (a warp per two positions, lanes along d four
// units at a time, eight taps at a time reduced by reduce_scatter8), then
// dcl[j] / dal[j] = sum over tt + k = j of P[tt][k] for the cumulative's /
// the attention's taps (positions t0 - 15 + j, j < 46). All threads.
template <typename W>
__device__ __forceinline__ void loc_grads4(const float (&dp)[TC], int d, bool unit, int D,
                                           const W* w01t, float* s_dp, float* P, float* dcl,
                                           float* dal) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, D4 = D / 4;
  if (unit) {
#pragma unroll
    for (int tt = 0; tt < TC; ++tt) s_dp[tt * D + d] = dp[tt];
  }
  __syncthreads();
  for (int tp = 2 * warp; tp < TC; tp += 2 * WARPS) {
    const float4* p0 = reinterpret_cast<const float4*>(s_dp + tp * D);
    const float4* p1 = reinterpret_cast<const float4*>(s_dp + (tp + 1) * D);
    for (int k0 = 0; k0 < NTAP; k0 += 8) {
      float v0[8], v1[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) v0[u] = v1[u] = 0.f;
      for (int dd = lane; dd < D4; dd += 32) {
        const float4 x0 = p0[dd], x1 = p1[dd];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const float4 wv =
              k0 + u < NTAP ? ld4i(w01t + (k0 + u) * D, dd) : make_float4(0.f, 0.f, 0.f, 0.f);
          v0[u] = fmaf(x0.x, wv.x, fmaf(x0.y, wv.y, fmaf(x0.z, wv.z, fmaf(x0.w, wv.w, v0[u]))));
          v1[u] = fmaf(x1.x, wv.x, fmaf(x1.y, wv.y, fmaf(x1.z, wv.z, fmaf(x1.w, wv.w, v1[u]))));
        }
      }
      const float r0 = res::reduce_scatter8(v0), r1 = res::reduce_scatter8(v1);
      const int k = k0 + (lane >> 2);
      if ((lane & 3) == 0 && k < NTAP) {
        P[tp * NTAP + k] = r0;
        P[(tp + 1) * NTAP + k] = r1;
      }
    }
  }
  __syncthreads();
  if (threadIdx.x < res::WIN) {
    const int j = threadIdx.x;
    float sc = 0.f, sa = 0.f;
#pragma unroll
    for (int tt = 0; tt < TC; ++tt) {
      const int k = j - tt;
      if (k >= 0 && k < CONV_K) {
        sc += P[tt * NTAP + k];
        sa += P[tt * NTAP + CONV_K + k];
      }
    }
    dcl[j] = sc;
    dal[j] = sa;
  }
  __syncthreads();
}

// Phase B of a backward item: the B7 body's (att_bwd_b: the original's
// chunk code on the item's positions, with S from the items' partials: the
// energies' recomputation, d(energy), d(tanh argument), d(encp), the v
// gradient and d(q)'s partial), with the location-weight gradient formed
// four taps at a time from register windows of 20 positions (each tap's sum
// in the original's order; 80 16-byte shared loads in place of about a
// thousand 4-byte ones) and the conv's input cotangents by loc_grads4. The
// utterance's last item to arrive sums d(q) in item order into c_dq.
template <typename ST>
__device__ __forceinline__ void att_b(const TfBwdArgs& a, const TBWork& wk, const ST* s_w01t,
                                      float* s_gw, float* s_pv, float* sc, int G, int nc, int b,
                                      int c, int g, long long* sub) {
  const res::BWork& w = wk.w;
  const int B = (int)a.B, T = (int)a.T, D = (int)a.D;
  const int t0 = c * TC, tc = min(TC, T - t0);
  float* cw = sc;
  float* aw = cw + res::WINP;
  float* dcl = aw + res::WINP;
  float* dal = dcl + res::WINP;
  float* red16 = dal + res::WINP;
  float* su = red16 + WARPS * TC;
  float* sdu = su + TC;
  float* misc = sdu + TC;
  float* P = misc + 16;                    // TC x 62
  float* part = P + TC * NTAP;             // nc
  float* s_dp = part + (nc + 3) / 4 * 4;   // TC x D
  const size_t gbb = (size_t)g * B + b;
  Prof ps;
  ps.start(sub);
  // the item's own operands first, in flight beside the sums below
  const int d = threadIdx.x;
  const bool unit = d < D;
  const float div = a.s_div[gbb];
  const float qd = unit ? a.s_q[gbb * D + d] : 0.f, vd = unit ? ldv(cs<ST>(a.v) + d) : 0.f;
  const float ds = threadIdx.x < tc ? __ldcg(w.dsb + (size_t)b * T + t0 + threadIdx.x) : 0.f;
  float ep[TC], old[TC];
  float* dencp_b = a.dencp + ((size_t)b * T + t0) * D + d;
#pragma unroll
  for (int tt = 0; tt < TC; ++tt) {
    ep[tt] = unit && tt < tc ? ldv(cs<ST>(a.encp) + (((size_t)b * T + t0 + tt) * D + d)) : 0.f;
    old[tt] = unit && tt < tc ? __ldcg(dencp_b + (size_t)tt * D) : 0.f;
  }
  // the windows and S's partials (phase A's, one an item) likewise
  float cw0 = 0.f, aw0 = 0.f;
  {
    const int j = threadIdx.x, t = t0 - CONV_HALF + j;
    const bool in = j < res::WIN && t >= 0 && t < T;
    if (in) cw0 = a.s_cum[gbb * T + t];
    if (in && g > 0) aw0 = a.scores[(gbb - B) * T + t];
  }
  const float sp = threadIdx.x < nc ? __ldcg(w.spart + (size_t)b * nc + threadIdx.x) : 0.f;
  __syncthreads();
  if (threadIdx.x < res::WINP) {
    cw[threadIdx.x] = cw0;
    aw[threadIdx.x] = aw0;
  }
  // S = sum of the partials in item order (res::ordered_sum's)
  if (threadIdx.x < nc) part[threadIdx.x] = sp;
  for (int k = threadIdx.x + THREADS; k < nc; k += THREADS)
    part[k] = __ldcg(w.spart + (size_t)b * nc + k);
  __syncthreads();
  if (threadIdx.x == 0) {
    float s0 = 0.f;
    for (int k = 0; k < nc; ++k) s0 += part[k];
    misc[0] = s0;
  }
  __syncthreads();
  ps.stamp(TB_B_SUM_WINDOWS);
  const float S = misc[0];
  float arg[TC], dp[TC];
  if (unit) {
    lsa_args_pre(arg, ep, tc, d, D, qd, cw, aw, s_w01t);
  } else {
#pragma unroll
    for (int tt = 0; tt < TC; ++tt) arg[tt] = 0.f;
  }
  lsa_u(arg, vd, red16, su);
  if (threadIdx.x < tc) {
    const float sig = sigm(su[threadIdx.x]);
    const float dsig = div > 0.f ? (ds - S) / div : ds;
    sdu[threadIdx.x] = dsig * sig * (1.f - sig);
  }
  __syncthreads();
  ps.stamp(TB_B_ENERGIES);
#pragma unroll
  for (int tt = 0; tt < TC; ++tt) dp[tt] = 0.f;
  if (unit) {
    float dv_d = 0.f, dq_d = 0.f;
#pragma unroll
    for (int tt = 0; tt < TC; ++tt) {
      if (tt < tc) {
        const float ar = arg[tt], du = sdu[tt];
        dp[tt] = du * vd * (1.f - ar * ar);
        dv_d = fmaf(du, ar, dv_d);
        dq_d += dp[tt];
        dencp_b[(size_t)tt * D] = old[tt] + dp[tt];
      }
    }
    ps.stamp(TB_B_DP_DENCP);
    // the location weight's gradient, column d: taps k0 .. k0 + 3 from the
    // windows' positions k0 .. k0 + 19 (16-byte aligned; WINP covers them)
#pragma unroll 1
    for (int k0 = 0; k0 < CONV_K; k0 += 4) {
      float wc[20], wa[20];
#pragma unroll
      for (int q = 0; q < 5; ++q) {
        const float4 x = reinterpret_cast<const float4*>(cw + k0)[q];
        const float4 y = reinterpret_cast<const float4*>(aw + k0)[q];
        wc[4 * q] = x.x; wc[4 * q + 1] = x.y; wc[4 * q + 2] = x.z; wc[4 * q + 3] = x.w;
        wa[4 * q] = y.x; wa[4 * q + 1] = y.y; wa[4 * q + 2] = y.z; wa[4 * q + 3] = y.w;
      }
      float gc[4], ga[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) gc[u] = ga[u] = 0.f;
#pragma unroll
      for (int tt = 0; tt < TC; ++tt)
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          gc[u] = fmaf(dp[tt], wc[tt + u], gc[u]);
          ga[u] = fmaf(dp[tt], wa[tt + u], ga[u]);
        }
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (k0 + u < CONV_K) {
          s_gw[(k0 + u) * D + d] += gc[u];
          s_gw[(CONV_K + k0 + u) * D + d] += ga[u];
        }
    }
    s_pv[d] += dv_d;
    w.dqpart[((size_t)b * nc + c) * D + d] = dq_d;
  }
  ps.stamp(TB_B_W01_GRAD);
  loc_grads4(dp, d, unit, D, s_w01t, s_dp, P, dcl, dal);
  ps.stamp(TB_B_CONV_COTANGENTS);
  if (threadIdx.x < res::WINP) {
    float* cb = w.contrib + ((size_t)b * nc + c) * 2 * res::WINP;
    cb[threadIdx.x] = dcl[threadIdx.x];
    cb[res::WINP + threadIdx.x] = dal[threadIdx.x];
  }
  const bool last = last_of_utterance(wk.cnt + b, nc, G - 1 - g, sc);
  ps.stamp(TB_B_CONTRIB);
  if (!last) return;
  for (int dd = threadIdx.x; dd < D; dd += THREADS)
    a.c_dq[gbb * D + dd] =
        strided_sum(w.dqpart + (size_t)b * nc * D + dd, nc, (size_t)D);
  ps.stamp(TB_B_DQ);
}

// d(enc)[b, t] = sum over g from G - 1 down to 0 of scores[g, b, t]
// dctx_t[g, b], tasks of (utterance, epi_tt positions), epi_gc groups' dctx
// a chunk in shared memory (the B7 body's contraction without d(aref)).
__device__ __forceinline__ void denc_product(const TfBwdArgs& a, const res::BWork& w,
                                             const ResPlan& p, float* sm) {
  const int G = (int)a.G, B = (int)a.B, T = (int)a.T, E = (int)a.E, E4 = E / 4;
  const int tt = (int)p.epi_tt, gc = (int)p.epi_gc, nblk = (int)p.nblk;
  const int ntile = (T + tt - 1) / tt;
  float* s_dc = sm;                       // gc x E
  float* s_ar = s_dc + (size_t)gc * E;    // gc x tt
  constexpr int NA = 8;
  for (int task = blockIdx.x; task < B * ntile; task += nblk) {
    const int b = task / ntile, t0 = (task % ntile) * tt, tn = min(tt, T - t0);
    float4 acc[NA];
#pragma unroll
    for (int i = 0; i < NA; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int g1 = G; g1 > 0; g1 -= gc) {
      const int g0 = max(0, g1 - gc), gn = g1 - g0;
      __syncthreads();
      for (int e = threadIdx.x; e < gn * E4; e += THREADS) {
        const int gi = e / E4, k = e - gi * E4;
        reinterpret_cast<float4*>(s_dc)[e] = __ldcg(
            reinterpret_cast<const float4*>(w.dctxt + ((size_t)(g0 + gi) * B + b) * E) + k);
      }
      for (int e = threadIdx.x; e < gn * tt; e += THREADS) {
        const int gi = e / tt, ti = e - gi * tt;
        s_ar[e] = ti < tn ? a.scores[((size_t)(g0 + gi) * B + b) * T + t0 + ti] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < NA; ++i) {
        const int o = threadIdx.x + i * THREADS;
        if (o < tn * E4) {
          const int ti = o / E4, k = o - ti * E4;
          for (int gi = gn - 1; gi >= 0; --gi) {
            const float st = s_ar[gi * tt + ti];
            const float4 v = reinterpret_cast<const float4*>(s_dc + (size_t)gi * E)[k];
            acc[i].x = fmaf(st, v.x, acc[i].x);
            acc[i].y = fmaf(st, v.y, acc[i].y);
            acc[i].z = fmaf(st, v.z, acc[i].z);
            acc[i].w = fmaf(st, v.w, acc[i].w);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      const int o = threadIdx.x + i * THREADS;
      if (o < tn * E4) reinterpret_cast<float4*>(a.denc + ((size_t)b * T + t0) * E)[o] = acc[i];
    }
  }
}


// S as in fwd: the weights, the streams and the masks are read as S; every
// cotangent and gradient stays float.
template <bool PROF, typename S>
__device__ __forceinline__ void bwd(const TfBwdArgs& a, const ResPlan& p, long long* prof_out) {
  const int G = (int)a.G, B = (int)a.B, E = (int)a.E, D = (int)a.D;
  const int P2 = (int)a.P2, L = (int)a.L, F = (int)a.F;
  const int nblk = (int)p.nblk, nc = (int)p.nc, ipb = (int)p.ipb;
  const int lane = threadIdx.x & 31;
  TBWork wk(a.work, a, p);
  const res::BWork& w = wk.w;
  Bar bar{w.bar, (u64)nblk, 0};
  Prof pf;
  pf.start(PROF ? prof_out : nullptr);

  extern __shared__ float smem[];
  S* s_w01t = ms<S>(smem + p.off_w01t);
  float* s_att = smem + p.off_att;
  float* X = smem + p.off_x;
  float* s_gw = p.gw_global ? a.pw01 + (size_t)blockIdx.x * NTAP * D : smem + p.off_gw;
  float* s_pv = smem + p.off_pv;

  // ---- prologue: dx2 = dmel @ wm for every group, enc's rows through
  // awi[:, :E]^T; then the location weight, the block's accumulators, and
  // LSTM2's cell backward at the last group (dh2 = dx2, dc2 = 0)
  {
    const GemmT<float, S, float> dx2{a.dmel, F, 1, cs<S>(a.wmT), F, 1, nullptr, wk.dx2all, L,
                                     (int64_t)G * B, L, F, 0};
    const GemmT<S, S, float> encw{cs<S>(a.enc), E, 1, cs<S>(a.awiT), 1, 3 * D, nullptr,
                                  wk.encw, 3 * D, (int64_t)B * a.T, 3 * D, E, 0};
    gemm2(dx2, encw, nblk, smem + 4);
  }
  for (int e = threadIdx.x; e < NTAP * D; e += THREADS) {
    s_w01t[e] = cs<S>(a.w01t)[e];
    s_gw[e] = 0.f;
  }
  for (int e = threadIdx.x; e < D; e += THREADS) s_pv[e] = 0.f;
  __syncthreads();
  bar.sync();
  for (int o = blockIdx.x * THREADS + threadIdx.x; o < B * L; o += nblk * THREADS) {
    const int b = o / L, j = o - b * L;
    const size_t gbb = (size_t)(G - 1) * B + b, so = gbb * L + j;
    const float cp = G > 1 ? ldv(cs<S>(a.s_c2) + (so - (size_t)B * L)) : 0.f;
    const LstmBwd r = lstm_bwd(__ldcg(wk.dx2all + so), 0.f, cs<S>(a.s_g2) + gbb * 4 * L, j, L,
                               ldv(cs<S>(a.s_c2) + so), cp, ldv(cs<S>(a.zm2) + so));
    float* dg = a.c_dg2 + gbb * 4 * L;
    for (int q = 0; q < 4; ++q) dg[q * L + j] = r.dg[q];
    w.dc2[o] = r.dc_prev;
    w.wz2[o] = r.wz;
  }
  bar.sync();
  pf.stamp(TB_PRO);

  // this block's attention items of group g, phase A or B
  auto items = [&](bool phase_b, int g) {
    for (int m = 0; m < ipb; ++m) {
      const int it = (int)blockIdx.x + m * nblk;
      if (it >= B * nc) break;
      if (phase_b)
        att_b(a, wk, s_w01t, s_gw, s_pv, s_att, G, nc, it / nc, it % nc, g,
              PROF ? prof_out : nullptr);
      else
        att_a<S>(a, wk, s_att, G, nc, it / nc, it % nc, g, PROF ? prof_out : nullptr);
    }
  };

  // iteration i: the GRU's backward of group i, the attention items of
  // group i - 1, the mel chain of group i - 2
  for (int i = G + 1; i >= 0; --i) {
    const int ga = i - 1, gm = i - 2;
    const bool att = ga >= 0 && ga < G, mel = gm >= 0 && gm < G;
    // ---- interval 1: the GRU's backward of group i on [dq_i | dgh_{i+1}]
    if (i < G) {
      const size_t gb = (size_t)i * B;
      const bool nx = i + 1 < G;
      const Seg segs[2] = {{a.c_dq + gb * D, D, D},
                           {nx ? a.c_dgh + gb * 3 * D + (size_t)B * 3 * D : nullptr, 3 * D, 3 * D}};
      res::kstage<1, 2, 1>(
          p, X, B, D, segs, 2,
          [&](float(&acc)[2][1][RB], int j, int, const float* Xt, int kcs, int c0, int c1,
              int nr) {
            res::kdots<1, false>(acc[0], cs<S>(a.wqT) + (size_t)j * D, 0, D, 0, Xt, kcs, c0, c1,
                                 nr);
            if (nx)
              res::kdots<1, false>(acc[1], cs<S>(a.awhT) + (size_t)j * 3 * D, 0, 3 * D, D, Xt, kcs,
                                   c0, c1, nr);
          },
          [&](float(&acc)[2][1][RB], int j, int, int b0, int nr) {
            if (lane < nr) {
              const int b = b0 + lane;
              const size_t gbb = gb + b, o = (size_t)b * D + j;
              // dah = dtz + dgh_{i+1} awh (the carry), + the rnn_input part,
              // + dq wq
              const float dah = __ldcg(w.dtz + o) + pick(acc[1][0], lane);
              const float dh = (dah + __ldcg(wk.rah + gbb * D + j)) + pick(acc[0][0], lane);
              const S* sg = cs<S>(a.s_gru) + gbb * 4 * D;
              const float r = ldv(sg + j), z = ldv(sg + (D + j)), n = ldv(sg + (2 * D + j)),
                          hn = ldv(sg + (3 * D + j));
              const float hp = i > 0 ? ldv(cs<S>(a.s_ah) + ((gbb - B) * D + j)) : 0.f;
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
              w.dtz[o] = dh * z;
            }
          });
    }
    pf.stamp(TB_GRU);
    // ---- the mel chain, group gm: dx1 = dx2 + dG2 l2wi and LSTM1's cell;
    // dh2 = z dh + dG2 l2wh and LSTM2's cell at gm - 1 ----
    if (mel) {
      const size_t gb = (size_t)gm * B;
      const Seg segs[1] = {{a.c_dg2 + gb * 4 * L, 4 * L, 4 * L}};
      res::kstage<1, 2, 2>(
          p, X, B, L, segs, 1,
          [&](float(&acc)[2][1][RB], int j, int, const float* Xt, int kcs, int c0, int c1,
              int nr) {
            res::kdots<1, false>(acc[0], cs<S>(a.l2wiT) + (size_t)j * 4 * L, 0, 4 * L, 0, Xt, kcs,
                                 c0, c1, nr);
            res::kdots<1, false>(acc[1], cs<S>(a.l2whT) + (size_t)j * 4 * L, 0, 4 * L, 0, Xt, kcs,
                                 c0, c1, nr);
          },
          [&](float(&acc)[2][1][RB], int j, int, int b0, int nr) {
            if (lane < nr) {
              const int b = b0 + lane;
              const size_t o = (size_t)b * L + j, so = (gb + b) * L + j;
              const float dx1 = __ldcg(wk.dx2all + so) + pick(acc[0][0], lane);
              const float cp = gm > 0 ? ldv(cs<S>(a.s_c1) + (so - (size_t)B * L)) : 0.f;
              const LstmBwd r = lstm_bwd(__ldcg(w.dh1 + o) + dx1, __ldcg(w.dc1 + o),
                                         cs<S>(a.s_g1) + (gb + b) * 4 * L, j, L,
                                         ldv(cs<S>(a.s_c1) + so), cp, ldv(cs<S>(a.zm1) + so));
              float* dg = a.c_dg1 + (gb + b) * 4 * L;
              for (int q = 0; q < 4; ++q) dg[q * L + j] = r.dg[q];
              w.dc1[o] = r.dc_prev;
              w.wz1[o] = r.wz;
              w.dx1[o] = dx1;
              if (gm > 0) {
                const size_t sp = so - (size_t)B * L;
                const float dh2 = __ldcg(w.wz2 + o) + pick(acc[1][0], lane);
                const float cp2 = gm > 1 ? ldv(cs<S>(a.s_c2) + (sp - (size_t)B * L)) : 0.f;
                const LstmBwd r2 = lstm_bwd(dh2 + __ldcg(wk.dx2all + sp), __ldcg(w.dc2 + o),
                                            cs<S>(a.s_g2) + (gb - B + b) * 4 * L, j, L,
                                            ldv(cs<S>(a.s_c2) + sp), cp2, ldv(cs<S>(a.zm2) + sp));
                float* dg2 = a.c_dg2 + (gb - B + b) * 4 * L;
                for (int q = 0; q < 4; ++q) dg2[q * L + j] = r2.dg[q];
                w.dc2[o] = r2.dc_prev;
                w.wz2[o] = r2.wz;
              }
            }
          });
    }
    pf.stamp(TB_M2);
    bar.sync();
    pf.stamp(TB_W1);
    if (i == 0) break;
    // ---- interval 2: phase A of group ga; dx0 = dx1 + dG1 l1wi and dh1 =
    // z dh + dG1 l1wh of group gm ----
    if (att) items(false, ga);
    pf.stamp(TB_A);
    if (mel) {
      const size_t gb = (size_t)gm * B;
      const Seg segs[1] = {{a.c_dg1 + gb * 4 * L, 4 * L, 4 * L}};
      res::kstage<1, 2, 2>(
          p, X, B, L, segs, 1,
          [&](float(&acc)[2][1][RB], int j, int, const float* Xt, int kcs, int c0, int c1,
              int nr) {
            res::kdots<1, false>(acc[0], cs<S>(a.l1wiT) + (size_t)j * 4 * L, 0, 4 * L, 0, Xt, kcs,
                                 c0, c1, nr);
            res::kdots<1, false>(acc[1], cs<S>(a.l1whT) + (size_t)j * 4 * L, 0, 4 * L, 0, Xt, kcs,
                                 c0, c1, nr);
          },
          [&](float(&acc)[2][1][RB], int j, int, int b0, int nr) {
            if (lane < nr) {
              const int b = b0 + lane;
              const size_t o = (size_t)b * L + j;
              a.c_dx0[(gb + b) * L + j] = __ldcg(w.dx1 + o) + pick(acc[0][0], lane);
              w.dh1[o] = __ldcg(w.wz1 + o) + pick(acc[1][0], lane);
            }
          });
    }
    pf.stamp(TB_M1);
    bar.sync();
    pf.stamp(TB_W2);
    // ---- interval 3: phase B of group ga (and its d(q)); dx0 @ wr of
    // group gm, split into its ctx and ah parts ----
    if (att) items(true, ga);
    pf.stamp(TB_B);
    if (mel) {
      const size_t gb = (size_t)gm * B;
      const Seg segs[1] = {{a.c_dx0 + gb * L, L, L}};
      res::kstage<1, 1, 2>(
          p, X, B, E + D, segs, 1,
          [&](float(&acc)[1][1][RB], int u, int, const float* Xt, int kcs, int c0, int c1,
              int nr) {
            res::kdots<1, false>(acc[0], cs<S>(a.wrT) + (size_t)u * L, 0, L, 0, Xt, kcs, c0, c1,
                                 nr);
          },
          [&](float(&acc)[1][1][RB], int u, int, int b0, int nr) {
            if (lane < nr) {
              const size_t gbb = gb + b0 + lane;
              const float v = pick(acc[0][0], lane);
              if (u < E)
                w.dctxt[gbb * E + u] = v;
              else
                wk.rah[gbb * D + u - E] = v;
            }
          });
    }
    pf.stamp(TB_R);
    bar.sync();
    pf.stamp(TB_W3);
  }
  // ---- epilogue: the block's v and location-weight gradients; d(ctx) =
  // rnn part + dgi_{g+1} awi[:, :E] and d(pre) = dgi awi[:, E:]; d(enc) ----
  __syncthreads();
  float* pw = a.pw01 + (size_t)blockIdx.x * NTAP * D;
  if (!p.gw_global)
    for (int e = threadIdx.x; e < NTAP * D; e += THREADS) pw[e] = s_gw[e];
  for (int e = threadIdx.x; e < D; e += THREADS) a.pv[(size_t)blockIdx.x * D + e] = s_pv[e];
  {
    const GemmT<float, S, float> dctx{a.c_dgi + (size_t)B * 3 * D, 3 * D, 1, cs<S>(a.awiT), 3 * D,
                                      1, nullptr, w.dctxt, E, (int64_t)(G - 1) * B, E, 3 * D, 1};
    const GemmT<float, S, float> dpre{a.c_dgi, 3 * D, 1, cs<S>(a.awiT) + (size_t)E * 3 * D, 3 * D,
                                      1, nullptr, a.dpre, P2, (int64_t)G * B, P2, 3 * D, 0};
    gemm2(dctx, dpre, nblk, smem + 4);
  }
  bar.sync();
  denc_product(a, w, p, smem + 4);
  pf.stamp(TB_EPI);
}

}  // namespace tfres

namespace {

__global__ void __launch_bounds__(THREADS, 1) taco_tf_res_fwd(TfFwdArgs a, ResPlan p) {
  tfres::fwd<false, float>(a, p, nullptr);
}
__global__ void __launch_bounds__(THREADS, 1)
    taco_tf_res_fwd_prof(TfFwdArgs a, ResPlan p, long long* prof) {
  tfres::fwd<true, float>(a, p, prof);
}
__global__ void __launch_bounds__(THREADS, 1) taco_tf_res_bwd(TfBwdArgs a, ResPlan p) {
  tfres::bwd<false, float>(a, p, nullptr);
}
__global__ void __launch_bounds__(THREADS, 1)
    taco_tf_res_bwd_prof(TfBwdArgs a, ResPlan p, long long* prof) {
  tfres::bwd<true, float>(a, p, prof);
}
// the bf16 instantiations (weights, streams, saved states and mel in bf16)
__global__ void __launch_bounds__(THREADS, 1) taco_tf_res_fwd_bf16(TfFwdArgs a, ResPlan p) {
  tfres::fwd<false, bf16_t>(a, p, nullptr);
}
__global__ void __launch_bounds__(THREADS, 1) taco_tf_res_bwd_bf16(TfBwdArgs a, ResPlan p) {
  tfres::bwd<false, bf16_t>(a, p, nullptr);
}

// The TF arm's weight gradients from the cotangent streams (taco_train.cu's
// wgrads() with the location-weight and v partials one per block of the
// grid).
template <typename S>
cudaError_t tf_res_wgrads(const TfBwdArgs& a, int64_t nparts, cudaStream_t st) {
  cudaError_t e;
  const int64_t R = a.G * a.B, B = a.B, D = a.D, E = a.E, P2 = a.P2, L = a.L, F = a.F;
  const S *s_ctx = cs<S>(a.s_ctx), *s_ah = cs<S>(a.s_ah);
  if ((e = gemm(st, a.c_dgi, 3 * D, s_ctx, E, B, a.dawi, E + P2, 3 * D, E, R))) return e;
  if ((e = gemm(st, a.c_dgi, 3 * D, cs<S>(a.pre), P2, 0, a.dawi + E, E + P2, 3 * D, P2, R)))
    return e;
  if ((e = csum(st, a.c_dgi, 3 * D, a.dabi, 3 * D, R))) return e;
  if ((e = gemm(st, a.c_dgh, 3 * D, s_ah, D, B, a.dawh, D, 3 * D, D, R))) return e;
  if ((e = csum(st, a.c_dgh, 3 * D, a.dabh, 3 * D, R))) return e;
  if ((e = gemm(st, a.c_dq, D, s_ah, D, 0, a.dwq, D, D, D, R))) return e;
  if ((e = csum(st, a.c_dq, D, a.dqb, D, R))) return e;
  if ((e = gemm(st, a.c_dx0, L, s_ctx, E, 0, a.dwr, E + D, L, E, R))) return e;
  if ((e = gemm(st, a.c_dx0, L, s_ah, D, 0, a.dwr + E, E + D, L, D, R))) return e;
  if ((e = csum(st, a.c_dx0, L, a.dbr, L, R))) return e;
  if ((e = gemm(st, a.c_dg1, 4 * L, cs<S>(a.s_x0), L, 0, a.dl1wi, L, 4 * L, L, R))) return e;
  if ((e = gemm(st, a.c_dg1, 4 * L, cs<S>(a.s_h1), L, B, a.dl1wh, L, 4 * L, L, R))) return e;
  if ((e = csum(st, a.c_dg1, 4 * L, a.dl1b, 4 * L, R))) return e;
  if ((e = gemm(st, a.c_dg2, 4 * L, cs<S>(a.s_x1), L, 0, a.dl2wi, L, 4 * L, L, R))) return e;
  if ((e = gemm(st, a.c_dg2, 4 * L, cs<S>(a.s_h2), L, B, a.dl2wh, L, 4 * L, L, R))) return e;
  if ((e = csum(st, a.c_dg2, 4 * L, a.dl2b, 4 * L, R))) return e;
  if ((e = gemm(st, a.dmel, F, cs<S>(a.s_x2), L, 0, a.dwm, L, F, L, R))) return e;
  reduce_parts<<<(unsigned)((NTAP * D + 255) / 256), 256, 0, st>>>(a.pw01, (int)nparts, NTAP,
                                                                    (int)D, 1, a.dw01);
  if ((e = cudaGetLastError())) return e;
  reduce_parts<<<(unsigned)((D + 255) / 256), 256, 0, st>>>(a.pv, (int)nparts, 1, (int)D, 0,
                                                            a.dv);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Floats of zeroed workspace the resident TF forward / backward needs.
int64_t wr_taco_tf_res_fwd_work_floats(const TfFwdArgs* a, const ResPlan* p) {
  return tfres::TWork<float>(nullptr, *a, *p).size;
}
int64_t wr_taco_tf_res_fwd_bf16_work_floats(const TfFwdArgs* a, const ResPlan* p) {
  return tfres::TWork<bf16_t>(nullptr, *a, *p).size;
}
int64_t wr_taco_tf_res_bwd_work_floats(const TfBwdArgs* a, const ResPlan* p) {
  return tfres::TBWork(nullptr, *a, *p).size;
}

// The forward over all G groups on `stream` (prof: null, or 64 int64
// counters on the device for the profiling instantiation); returns the
// CUDA error code.
int wr_taco_tf_res_fwd(const TfFwdArgs* args, const ResPlan* plan, long long* prof,
                       void* stream) {
  TfFwdArgs a = *args;
  ResPlan p = *plan;
  if (a.D > THREADS) return cudaErrorInvalidValue;
  if (prof) {
    void* kargs[] = {&a, &p, &prof};
    return launch_res((const void*)taco_tf_res_fwd_prof, p, kargs, (cudaStream_t)stream);
  }
  void* kargs[] = {&a, &p};
  return launch_res((const void*)taco_tf_res_fwd, p, kargs, (cudaStream_t)stream);
}

// The backward: the reverse sweep, then every weight gradient from the
// cotangent streams it wrote. Returns the CUDA error code.
int wr_taco_tf_res_bwd(const TfBwdArgs* args, const ResPlan* plan, long long* prof,
                       void* stream) {
  TfBwdArgs a = *args;
  ResPlan p = *plan;
  const cudaStream_t st = (cudaStream_t)stream;
  if (a.D > THREADS) return cudaErrorInvalidValue;
  cudaError_t e;
  if (prof) {
    void* kargs[] = {&a, &p, &prof};
    e = launch_res((const void*)taco_tf_res_bwd_prof, p, kargs, st);
  } else {
    void* kargs[] = {&a, &p};
    e = launch_res((const void*)taco_tf_res_bwd, p, kargs, st);
  }
  if (e != cudaSuccess) return e;
  return tf_res_wgrads<float>(a, p.nblk, st);
}

// The bf16 forward and backward (as taco_train_resident.cu's _bf16 entries).
int wr_taco_tf_res_fwd_bf16(const TfFwdArgs* args, const ResPlan* plan, void* stream) {
  TfFwdArgs a = *args;
  ResPlan p = *plan;
  if (a.D > THREADS) return cudaErrorInvalidValue;
  void* kargs[] = {&a, &p};
  return launch_res((const void*)taco_tf_res_fwd_bf16, p, kargs, (cudaStream_t)stream);
}
int wr_taco_tf_res_bwd_bf16(const TfBwdArgs* args, const ResPlan* plan, void* stream) {
  TfBwdArgs a = *args;
  ResPlan p = *plan;
  const cudaStream_t st = (cudaStream_t)stream;
  if (a.D > THREADS) return cudaErrorInvalidValue;
  void* kargs[] = {&a, &p};
  const cudaError_t e = launch_res((const void*)taco_tf_res_bwd_bf16, p, kargs, st);
  if (e != cudaSuccess) return e;
  return tf_res_wgrads<bf16_t>(a, p.nblk, st);
}

}  // extern "C"
