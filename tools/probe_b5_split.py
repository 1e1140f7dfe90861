"""Per-stage cycle split of kernel B5's step on one H100, for either body:
the first (csrc/gru_seq.cu: gru_fwd / gru_bwd, reached through the
wrappers' _legacy=True) or, with --resident, the resident body
(csrc/gru_resident.cu: gru_res_fwd / gru_res_bwd).

Builds a profiling copy of the source (the source itself is not changed):
clock64() stamps at every stage boundary of a step, the cycles between
consecutive stamps summed over all steps on block 0 and on the grid's last
block (the resident body's in registers, written out at the end).

First body, forward: the gi loads issued, h_{t-1} staged from L2 into
shared memory, the product, the gate math, the grid barrier's wait;
backward: the gate step, the grid barrier's wait, the next step's gate
inputs loaded, the dh product. Resident body, forward: the product, the
partial sums' reduction, the gate math, the exchange's start (the bulk
copies of the block's h_t slice issued, or the cluster barrier's arrive),
the streams' stores and the next step's loads issued, the wait for the
peers' slices (an mbarrier, or the barrier), the gather of the peers'
slices (the barrier's scheme only); backward: the gate step, the product
of the partial dh, the arrive, the stores and loads, the wait, the sum of
the peers' partials. Prints cycles per step for each stage at the
vocoder's training shape (T 1375, B 32, H 512) and the CBHG postnet's (T
770, B 32, H 128), float32, with the SM clock and its limit reasons read
around the runs and the body's times at each shape.

    python3 tools/probe_b5_split.py [--resident]
"""
import ctypes
import json
import subprocess
import sys
import time

import torch

sys.path.insert(0, ".")
import chip_smoke as cs  # noqa: E402
from wavernn_tpu_torch.ops import _build, cuda_gru  # noqa: E402

HEAD = r"""
__device__ unsigned long long g_prof[2][64];
#define PROF_INIT long long _pt = clock64(); \
  const int _pw = blockIdx.x == 0 ? 0 : (blockIdx.x == gridDim.x - 1 ? 1 : -1);
#define PROF(i) do { if (_pw >= 0 && threadIdx.x == 0) { \
  const long long _n = clock64(); g_prof[_pw][i] += _n - _pt; _pt = _n; } } while (0)
"""
# the resident body's stamps: cycles summed in registers by every thread
# (no memory traffic inside the step), block 0's and the last block's
# thread 0 adding them to g_prof at the end
HEAD_REG = r"""
__device__ unsigned long long g_prof[2][64];
#define PROF_INIT long long _pt = clock64(); unsigned _acc[8] = {0, 0, 0, 0, 0, 0, 0, 0}; \
  const int _pw = blockIdx.x == 0 ? 0 : (blockIdx.x == gridDim.x - 1 ? 1 : -1);
#define PROF(i) do { const long long _n = clock64(); _acc[(i) & 7] += (unsigned)(_n - _pt); \
  _pt = _n; } while (0)
#define PROF_FLUSH(base) do { if (_pw >= 0 && threadIdx.x == 0) \
  for (int _k = 0; _k < 8; ++_k) g_prof[_pw][(base) + _k] += _acc[_k]; } while (0)
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
FWD = ["gi_loads", "h_staging", "product", "gate_math", "barrier_wait"]
BWD = ["gate_step", "barrier_wait", "next_inputs", "dh_product"]
RES_FWD = ["product", "gate_sums", "gate_math", "exchange", "stores_loads",
           "wait", "gather"]
RES_BWD = ["gate_step", "product", "arrive", "stores_loads", "wait",
           "reduce"]  # arrive: the cluster barrier's (pull only)
B0 = 32   # backward stamps start here
SHAPES = {"vocoder": (1375, 32, 512), "cbhg_postnet": (770, 32, 128)}


def subs():
    """(old, new, count) edits of the source text."""
    f = FWD.index
    b = lambda k: B0 + BWD.index(k)
    return [
        ("#include <stdint.h>\n", "#include <stdint.h>\n" + HEAD, 1),
        # forward
        ("  for (int t = 0; t < T; ++t) {\n    const S* hsrc",
         "  PROF_INIT\n  for (int t = 0; t < T; ++t) {\n    const S* hsrc", 1),
        ("      __syncthreads();  // h_s and red free again\n",
         f"      PROF({f('gi_loads')});\n"
         "      __syncthreads();  // h_s and red free again\n", 1),
        ("      __syncthreads();\n      // (row, unit) pairs, the reduction",
         f"      __syncthreads();\n      PROF({f('h_staging')});\n"
         "      // (row, unit) pairs, the reduction", 1),
        ("      __syncthreads();\n      for (int p = tid; p < P; p += THREADS) {",
         f"      __syncthreads();\n      PROF({f('product')});\n"
         "      for (int p = tid; p < P; p += THREADS) {", 1),
        ("    grid.sync();  // ys[t] complete before any block stages it\n",
         f"    PROF({f('gate_math')});\n"
         "    grid.sync();  // ys[t] complete before any block stages it\n"
         f"    PROF({f('barrier_wait')});\n", 1),
        # backward
        ("  for (int t = T - 1; t >= 0; --t) {\n    // gate gradients",
         "  PROF_INIT\n  for (int t = T - 1; t >= 0; --t) {\n    // gate gradients", 1),
        ("    grid.sync();  // dgh[t] complete in every block\n"
         "    if (mine && t > 0) pre = load_gate<S>(a, t - 1, tid / U, u0 + tid % U);\n",
         f"    PROF({b('gate_step')});\n"
         "    grid.sync();  // dgh[t] complete in every block\n"
         f"    PROF({b('barrier_wait')});\n"
         "    if (mine && t > 0) pre = load_gate<S>(a, t - 1, tid / U, u0 + tid % U);\n"
         f"    PROF({b('next_inputs')});\n", 1),
        ("    __syncthreads();  // this block's dh before its next gate step\n",
         "    __syncthreads();  // this block's dh before its next gate step\n"
         f"    PROF({b('dh_product')});\n", 1),
    ]


def res_subs():
    """(old, new, count) edits of csrc/gru_resident.cu."""
    f = RES_FWD.index
    b = lambda k: B0 + RES_BWD.index(k)
    arrive = ("    cluster_arrive();\n    // the streams' stores after the "
              "arrive, so its release waits for none\n    // of them\n")
    return [
        ("#include <stdint.h>\n", "#include <stdint.h>\n" + HEAD_REG, 1),
        ("  // push: no block leaves while a copy into or out of it may be in flight\n",
         "  PROF_FLUSH(0);\n"
         "  // push: no block leaves while a copy into or out of it may be in flight\n", 1),
        ("  // no block leaves while a peer may still read its buffers\n",
         f"  PROF_FLUSH({B0});\n  // no block leaves while a peer may still read its buffers\n", 1),
        # forward
        ("  float o[PMAX][5];", "  PROF_INIT\n  float o[PMAX][5];", 1),
        ("        red_sums<RB>(p, red, b, u, gh);\n",
         f"        red_sums<RB>(p, red, b, u, gh);\n        PROF({f('gate_sums')});\n", 1),
        ("emit);\n    __syncthreads();\n",
         f"emit);\n    __syncthreads();\n    PROF({f('product')});\n", 1),
        ("        o[i][4] = hn;\n      }\n    }\n    if (push) {",
         f"        o[i][4] = hn;\n      }}\n    }}\n    PROF({f('gate_math')});\n"
         "    if (push) {", 1),
        ("    } else {\n      cluster_arrive();\n    }\n",
         "    } else {\n      cluster_arrive();\n    }\n"
         f"    PROF({f('exchange')});\n", 1),
        ("    if (t + 1 < T) load_gi(t + 1);\n    if (push) {",
         f"    if (t + 1 < T) load_gi(t + 1);\n    PROF({f('stores_loads')});\n"
         "    if (push) {", 1),
        ("(uint32_t)((t >> 1) & 1));\n",
         f"(uint32_t)((t >> 1) & 1));\n      PROF({f('wait')});\n", 1),
        ("      cluster_wait();\n      // the last step's",
         f"      cluster_wait();\n      PROF({f('wait')});\n      // the last step's", 1),
        ("        gather(p, cluster, xbuf, tile, nb, H);\n        __syncthreads();\n",
         "        gather(p, cluster, xbuf, tile, nb, H);\n        __syncthreads();\n"
         f"        PROF({f('gather')});\n", 1),
        # backward
        ("  for (int t = T - 1; t >= 0; --t) {",
         "  PROF_INIT\n  for (int t = T - 1; t >= 0; --t) {", 1),
        ("    __syncthreads();\n    // partial dh of every unit",
         f"    PROF({b('gate_step')});\n"
         "    __syncthreads();\n    // partial dh of every unit", 1),
        ("                    });\n    if (!push) cluster_arrive();\n",
         f"                    }});\n    PROF({b('product')});\n"
         f"    if (!push) cluster_arrive();\n    PROF({b('arrive')});\n", 1),
        ("    if (t > 0) load_in(t - 1);\n    if (push) {",
         f"    if (t > 0) load_in(t - 1);\n    PROF({b('stores_loads')});\n"
         "    if (push) {", 1),
        ("      cluster_wait();\n    }\n    // dh of the own units",
         f"      cluster_wait();\n    }}\n    PROF({b('wait')});\n"
         "    // dh of the own units", 1),
        ("      }\n    }\n    // push: the next gate step",
         f"      }}\n    }}\n    PROF({b('reduce')});\n    // push: the next gate step", 1),
    ]


def profiled_source(resident: bool = False) -> str:
    name = "gru_resident" if resident else "gru_seq"
    src = (_build.CSRC / f"{name}.cu").read_text()
    for old, new, n in (res_subs() if resident else subs()):
        got = src.count(old)
        if got != n:
            raise RuntimeError(f"profile edit matched {got} times, not {n}: "
                               f"{old[:60]!r}")
        src = src.replace(old, new)
    return src + TAIL


def build(resident: bool = False) -> ctypes.CDLL:
    out = _build.BUILD_DIR / "probe"
    out.mkdir(parents=True, exist_ok=True)
    name = "gru_resident" if resident else "gru_seq"
    cu, so = out / f"{name}_prof.cu", out / f"lib{name}_prof.so"
    cu.write_text(profiled_source(resident))
    cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-Xptxas", "-v",
           "-I", str(_build.CSRC), "-o", str(so), str(cu)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(res.stdout + res.stderr)
    return ctypes.CDLL(str(so))


def main():
    resident = "--resident" in sys.argv[1:]
    lib_name = "gru_resident" if resident else "gru_seq"
    legacy = not resident
    fwd_labels, bwd_labels = (RES_FWD, RES_BWD) if resident else (FWD, BWD)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    print(cs.smi_line(), flush=True)
    host = (ctypes.c_ulonglong * 128)()
    orig = _build.load(lib_name)
    prof = build(resident)
    prof.wr_prof_read.argtypes = [ctypes.c_void_p]
    out = {"body": lib_name}
    for tag, (T, B, H) in SHAPES.items():
        gi, wh, bh, h0, dys = cs.gru_inputs(T, B, H, torch.float32, dev, 3)
        fwd = lambda: cuda_gru.gru_seq_fwd(gi, wh, bh, h0, _legacy=legacy)
        res = {"T": T, "B": B, "H": H}
        if resident:
            res["plan"] = [cuda_gru.resident_launch_plan(B, H, torch.float32,
                                                         bw)
                           for bw in (False, True)]
        else:
            res["plan"] = [cuda_gru.launch_plan(B, H, torch.float32, bw)
                           for bw in (False, True)]
        with torch.no_grad():
            _build._libs[lib_name] = orig
            ys, sv = fwd()
            bwd = lambda: cuda_gru.gru_seq_bwd(sv, ys, wh, h0, dys,
                                               _legacy=legacy)
            clk = [cs.gpu_clocks()]
            res["body_ms"] = {"fwd": cs.cuda_ms(fwd, 3)[0],
                              "bwd": cs.cuda_ms(bwd, 3)[0]}
            _build._libs[lib_name] = prof
            fwd()   # warm-up
            bwd()
            torch.cuda.synchronize()
            for name, fn in (("fwd", fwd), ("bwd", bwd)):
                prof.wr_prof_reset()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                prof.wr_prof_read(host)
                labels, base = ((fwd_labels, 0) if name == "fwd"
                                else (bwd_labels, B0))
                per = {}
                for blk, where in ((0, "block0"), (1, "last_block")):
                    per[where] = {lab: host[blk * 64 + base + i] / T
                                  for i, lab in enumerate(labels)}
                    per[where]["total"] = sum(per[where][lab]
                                              for lab in labels)
                res[name] = {"cycles_per_step": per,
                             "wall_ms_profiled": 1e3 * wall}
            res["profiled_copy_ms"] = {"fwd": cs.cuda_ms(fwd, 3)[0],
                                       "bwd": cs.cuda_ms(bwd, 3)[0]}
            clk.append(cs.gpu_clocks())
            res["clocks"] = clk
        _build._libs[lib_name] = orig
        out[tag] = res
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
