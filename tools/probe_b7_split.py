"""Per-stage cycle split of kernel B7's original body (csrc/taco_train.cu,
the AF arm: taco_af_fwd / taco_af_bwd) on one H100.

Builds a profiling copy of csrc/taco_train.cu (the source itself is not
changed): clock64() stamps are inserted at every stage boundary of a
group, and inside the attention stage of each direction, and the cycles
between consecutive stamps are summed over all groups on block 0 (an
attention block: it owns utterance 0) and on the grid's last block (no
attention work at B 32, so its wait at the attention barrier is the
attention stage's length). Prints cycles per group for each interval, the
SM clock read with nvidia-smi around the runs, and the original body's
times at the same shape.

    python3 tools/probe_b7_split.py            # b7 full shape: B 32,
                                               # T_text 150, 200 groups, r 2
"""
import ctypes
import json
import subprocess
import sys
import time

import torch

sys.path.insert(0, ".")
import chip_smoke as cs  # noqa: E402
from wavernn_tpu_torch.ops import _build  # noqa: E402
from wavernn_tpu_torch.ops import cuda_taco_train as ct  # noqa: E402

HEAD = r"""
__device__ unsigned long long g_prof[2][64];
#define PROF_INIT long long _pt = clock64(); \
  const int _pw = blockIdx.x == 0 ? 0 : (blockIdx.x == gridDim.x - 1 ? 1 : -1);
#define PROF(i) do { if (_pw >= 0 && threadIdx.x == 0) { \
  const long long _n = clock64(); g_prof[_pw][i] += _n - _pt; _pt = _n; } } while (0)
"""
TAIL = r"""
extern "C" int wr_prof_reset() {
  static unsigned long long z[2][64] = {};
  return (int)cudaMemcpyToSymbol(g_prof, z, sizeof(z));
}
extern "C" int wr_prof_read(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_prof, sizeof(g_prof));
}
"""

# (label, stamp) in the order of a group; the stamp index is the position
FWD = ["prenet", "prenet_wait", "gru", "mel_prev_group", "gru_wait",
       "att_load", "att_q", "att_energies", "att_normaliser", "att_context",
       "att_wait", "rnn_input", "rnn_input_wait", "lstm1", "lstm1_wait",
       "lstm2", "lstm2_wait", "mel_last_group"]
BWD = ["s1_mel_lstm2", "s1_wait", "s2_lstm1", "s2_wait", "s3_dx0", "s3_wait",
       "s4_rnn_input", "s4_wait", "s5_load", "s5_ctx_contraction",
       "s5_normaliser", "s5_recompute", "s5_dp_dencp_gw", "s5_loc_input_grad",
       "s5_partials_carries", "s5_dah", "s5_gru_bwd", "s5_prenet_bwd",
       "s5_wait", "s7_gi_gh"]
B0 = 32   # backward stamps start here


def F(label):
    return f"PROF({FWD.index(label)});"


def Bk(label):
    return f"PROF({B0 + BWD.index(label)});"


def subs():
    """(old, new, count) edits of the source text."""
    return [
        ("#include <stdint.h>\n", "#include <stdint.h>\n" + HEAD, 1),
        ("  FwdWork wk(a.work, a);\n", "  FwdWork wk(a.work, a);\n  PROF_INIT\n", 1),
        ("  BwdWork wk(a.work, a);\n", "  BwdWork wk(a.work, a);\n  PROF_INIT\n", 1),
        # forward
        ("      af_prenet(x, a.wm + (size_t)(F - x.NM) * L, wk.x2, g, B, L, P2, sm);\n"
         "      grid.sync();\n",
         "      af_prenet(x, a.wm + (size_t)(F - x.NM) * L, wk.x2, g, B, L, P2, sm);\n"
         f"      {F('prenet')}\n      grid.sync();\n      {F('prenet_wait')}\n", 1),
        ("    if (g > 0) mel_stage(g - 1);\n    grid.sync();\n",
         f"    {F('gru')}\n    if (g > 0) mel_stage(g - 1);\n    {F('mel_prev_group')}\n"
         f"    grid.sync();\n    {F('gru_wait')}\n", 1),
        ("      rows_matvec(a.wq, D, D, s_ah, a.qb, s_q);\n      __syncthreads();\n",
         f"      {F('att_load')}\n      rows_matvec(a.wq, D, D, s_ah, a.qb, s_q);\n"
         f"      __syncthreads();\n      {F('att_q')}\n", 1),
        ("        if (threadIdx.x < tc) s_sig[t0 + threadIdx.x] = sigm(s_u[threadIdx.x]);\n"
         "      }\n      __syncthreads();\n",
         "        if (threadIdx.x < tc) s_sig[t0 + threadIdx.x] = sigm(s_u[threadIdx.x]);\n"
         f"      }}\n      __syncthreads();\n      {F('att_energies')}\n", 1),
        ("      if constexpr (AF) {   // the context weights",
         f"      {F('att_normaliser')}\n      if constexpr (AF) {{   // the context weights", 1),
        ("        if (threadIdx.x == 0) a.s_div[gb + b] = div;\n      }\n    }\n    grid.sync();\n",
         "        if (threadIdx.x == 0) a.s_div[gb + b] = div;\n      }\n"
         f"      {F('att_context')}\n    }}\n    grid.sync();\n    {F('att_wait')}\n", 1),
        ("                     if (save) a.s_x0[(gb + b) * L + j] = x0;\n"
         "                   }\n                 });\n    }\n    grid.sync();\n",
         "                     if (save) a.s_x0[(gb + b) * L + j] = x0;\n"
         f"                   }}\n                 }});\n    }}\n    {F('rnn_input')}\n"
         f"    grid.sync();\n    {F('rnn_input_wait')}\n", 1),
        ("                 });\n      grid.sync();\n    }\n    cur = nxt;",
         f"                 }});\n      PROF({FWD.index('lstm1')} + 2 * layer);\n"
         f"      grid.sync();\n      PROF({FWD.index('lstm1_wait')} + 2 * layer);\n"
         "    }\n    cur = nxt;", 1),
        ("  mel_stage(G - 1);\n}", f"  mel_stage(G - 1);\n  {F('mel_last_group')}\n}}", 1),
        # backward
        ("    grid.sync();\n    // ---- 2:",
         f"    {Bk('s1_mel_lstm2')}\n    grid.sync();\n    {Bk('s1_wait')}\n    // ---- 2:", 1),
        ("    grid.sync();\n    // ---- 3:",
         f"    {Bk('s2_lstm1')}\n    grid.sync();\n    {Bk('s2_wait')}\n    // ---- 3:", 1),
        ("    grid.sync();\n    // ---- 4:",
         f"    {Bk('s3_dx0')}\n    grid.sync();\n    {Bk('s3_wait')}\n    // ---- 4:", 1),
        ("    grid.sync();\n    // ---- 5:",
         f"    {Bk('s4_rnn_input')}\n    grid.sync();\n    {Bk('s4_wait')}\n    // ---- 5:", 1),
        ("      __syncthreads();\n      // ds = d(scores)",
         f"      __syncthreads();\n      {Bk('s5_load')}\n      // ds = d(scores)", 1),
        ("      float part = 0.f;\n"
         "      for (int t = threadIdx.x; t < T; t += THREADS) part += s_ds[t] * s_s[t];\n"
         "      const float S = block_sum(part, red);\n",
         f"      {Bk('s5_ctx_contraction')}\n      float part = 0.f;\n"
         "      for (int t = threadIdx.x; t < T; t += THREADS) part += s_ds[t] * s_s[t];\n"
         f"      const float S = block_sum(part, red);\n      {Bk('s5_normaliser')}\n", 1),
        ("          s_du[threadIdx.x] = dsig * sig * (1.f - sig);\n        }\n"
         "        __syncthreads();\n",
         "          s_du[threadIdx.x] = dsig * sig * (1.f - sig);\n        }\n"
         f"        __syncthreads();\n        {Bk('s5_recompute')}\n", 1),
        ("        // the location conv's input cotangents, cumulative then attention\n",
         f"        {Bk('s5_dp_dencp_gw')}\n"
         "        // the location conv's input cotangents, cumulative then attention\n", 1),
        ("        loc_input_grad(dp, d, unit, D, s_w01t, CONV_K, redj, daw + t0);\n      }\n",
         "        loc_input_grad(dp, d, unit, D, s_w01t, CONV_K, redj, daw + t0);\n"
         f"        {Bk('s5_loc_input_grad')}\n      }}\n", 1),
        ("      __syncthreads();\n      // dah = dahp + dq @ wq\n"
         "      rows_matvec(a.wqT, D, D, s_dq, wk.dahp + (size_t)b * D, s_dah);\n"
         "      __syncthreads();\n",
         f"      __syncthreads();\n      {Bk('s5_partials_carries')}\n"
         "      // dah = dahp + dq @ wq\n"
         "      rows_matvec(a.wqT, D, D, s_dq, wk.dahp + (size_t)b * D, s_dah);\n"
         f"      __syncthreads();\n      {Bk('s5_dah')}\n", 1),
        ("      if constexpr (AF) {\n        // the prenet's backward",
         f"      {Bk('s5_gru_bwd')}\n      if constexpr (AF) {{\n        // the prenet's backward", 1),
        ("    }\n    grid.sync();\n    // ---- 7:",
         f"      {Bk('s5_prenet_bwd')}\n    }}\n    grid.sync();\n    {Bk('s5_wait')}\n"
         "    // ---- 7:", 1),
        ("                       wk.dah[o] = __ldcg(wk.dtz + o) + v;\n"
         "                     }\n                   }\n                 });\n    }\n  }\n}",
         "                       wk.dah[o] = __ldcg(wk.dtz + o) + v;\n"
         "                     }\n                   }\n                 });\n    }\n"
         f"    {Bk('s7_gi_gh')}\n  }}\n}}", 1),
    ]


def profiled_source() -> str:
    src = (_build.CSRC / "taco_train.cu").read_text()
    for old, new, n in subs():
        got = src.count(old)
        if got != n:
            raise RuntimeError(f"profile edit matched {got} times, not {n}: "
                               f"{old[:60]!r}")
        src = src.replace(old, new)
    return src + TAIL


def build() -> ctypes.CDLL:
    out = _build.BUILD_DIR / "probe"
    out.mkdir(parents=True, exist_ok=True)
    cu, so = out / "taco_train_prof.cu", out / "libtaco_train_prof.so"
    cu.write_text(profiled_source())
    cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-Xptxas", "-v",
           "-I", str(_build.CSRC), "-o", str(so), str(cu)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(res.stdout + res.stderr)
    return ctypes.CDLL(str(so))


def main():
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    print(cs.smi_line(), flush=True)
    B, T, G, r = cs.B7_FULL
    ins, w = cs.b7_case(B, T, G, r, dev, 34, True)
    host = (ctypes.c_ulonglong * 128)()
    out = {"shape": {"B": B, "T_text": T, "G": G, "r": r}}
    with torch.no_grad():
        # the original body as built, then the profiled copy in its place
        mel, sc, st = ct.decoder_af_fwd(*ins, w, save=True)
        dmel, dsc = torch.randn_like(mel), torch.randn_like(sc)
        clk = [cs.gpu_clocks()]
        f_ms, _ = cs.cuda_ms(lambda: ct.decoder_af_fwd(*ins, w, save=True), 3)
        b_ms, _ = cs.cuda_ms(lambda: ct.decoder_af_bwd(dmel, dsc, st, sc,
                                                        *ins, w), 3)
        out["original_ms"] = {"fwd": f_ms, "bwd": b_ms}
        lib = build()
        lib.wr_prof_read.argtypes = [ctypes.c_void_p]
        _build._libs["taco_train"] = lib
        ct.decoder_af_fwd(*ins, w, save=True)   # warm-up
        ct.decoder_af_bwd(dmel, dsc, st, sc, *ins, w)
        torch.cuda.synchronize()
        for name, fn in (("fwd", lambda: ct.decoder_af_fwd(*ins, w, save=True)),
                         ("bwd", lambda: ct.decoder_af_bwd(dmel, dsc, st, sc,
                                                           *ins, w))):
            lib.wr_prof_reset()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            lib.wr_prof_read(host)
            labels, base = (FWD, 0) if name == "fwd" else (BWD, B0)
            per = {}
            for blk, tag in ((0, "block0"), (1, "last_block")):
                per[tag] = {lab: host[blk * 64 + base + i] / G
                            for i, lab in enumerate(labels)}
                per[tag]["total"] = sum(per[tag][lab] for lab in labels)
            out[name] = {"cycles_per_group": per, "wall_ms_profiled": 1e3 * wall}
        clk.append(cs.gpu_clocks())
        out["clocks"] = clk
        f_ms, _ = cs.cuda_ms(lambda: ct.decoder_af_fwd(*ins, w, save=True), 3)
        b_ms, _ = cs.cuda_ms(lambda: ct.decoder_af_bwd(dmel, dsc, st, sc,
                                                        *ins, w), 3)
        out["profiled_copy_ms"] = {"fwd": f_ms, "bwd": b_ms}
    print(json.dumps(out, indent=1), flush=True)


if __name__ == "__main__":
    main()
