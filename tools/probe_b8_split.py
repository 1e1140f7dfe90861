"""Per-stage cycle split of a free-running decoder group on the original
decode body (csrc/taco_decode.cu: taco_decode, kernel B2, and
taco_decode_batch, kernel B8) on one H100.

Builds a profiling copy of csrc/taco_decode.cu (the source itself is not
changed): clock64() stamps before and after every grid barrier of a group
(ten: prenet fc1 and fc2, the attention GRUCell, the query, the LSA
energies, the normaliser and context, rnn_input, LSTM1, LSTM2, mel_proj),
after the stop test and after the emit. The cycles between consecutive
stamps are summed over all groups on block 0 (which also emits every
output) and on the grid's last block. Prints cycles per group for each
interval, the SM clock and clock-limit reasons read with nvidia-smi
around each set, and the original body's own times at each shape (no
stamps). Random Tacotron weights from a seed at the default widths, r 2,
200 groups, no stop; the encoder runs as a plain step loop.

    python3 tools/probe_b8_split.py     # ~1 min of command time
"""
import ctypes
import json
import subprocess
import sys

import torch

sys.path.insert(0, ".")
import chip_smoke as cs  # noqa: E402
from wavernn_tpu_torch.config import Config  # noqa: E402
from wavernn_tpu_torch.models import tacotron as taco  # noqa: E402
from wavernn_tpu_torch.ops import _build  # noqa: E402
from wavernn_tpu_torch.ops import cuda_taco as ctd  # noqa: E402
from wavernn_tpu_torch.ops import layers as L  # noqa: E402
from wavernn_tpu_torch.text import text_to_sequence  # noqa: E402

HEAD = r"""
__device__ unsigned long long g_prof[2][64];
#define PROF_INIT long long _pt = 0; int _ps = 0; \
  const int _pw = blockIdx.x == 0 ? 0 : (blockIdx.x == gridDim.x - 1 ? 1 : -1);
#define PROF_GROUP do { if (_pw >= 0 && threadIdx.x == 0) _pt = clock64(); \
  _ps = 0; } while (0);
#define PROF_STAMP do { if (_pw >= 0 && threadIdx.x == 0) { \
  const long long _n = clock64(); g_prof[_pw][_ps] += _n - _pt; _pt = _n; } \
  ++_ps; } while (0);
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

STAGES = ("fc1", "fc2", "gru", "query", "lsa", "context", "rnn_input",
          "lstm1", "lstm2", "mel")
LABELS = [x for s in STAGES for x in (s, s + "_wait")] + ["stop", "emit"]


def subs():
    """(old, new, count) edits of the source text."""
    return [
        ("#include <stdint.h>\n", "#include <stdint.h>\n" + HEAD, 1),
        ("  Work wk(a.work, a);\n", "  Work wk(a.work, a);\n  PROF_INIT\n", 1),
        ("  BWork wk(a.work, a);\n", "  BWork wk(a.work, a);\n  PROF_INIT\n", 1),
        ("  for (int g = 0; g < (int)a.n_groups; ++g) {\n",
         "  for (int g = 0; g < (int)a.n_groups; ++g) {\n    PROF_GROUP\n", 2),
        # nine in each kernel's text (the LSTM loop's one for both layers)
        ("grid.sync();", "PROF_STAMP grid.sync(); PROF_STAMP", 18),
        ("    // ---- emit: the live group or the frozen replay ----\n",
         "    PROF_STAMP\n    // ---- emit: the live group or the frozen replay ----\n", 1),
        ("    // ---- emit: each row's live group or its frozen replay ----\n",
         "    PROF_STAMP\n    // ---- emit: each row's live group or its frozen replay ----\n",
         1),
        ("  }\n  if (blockIdx.x == 0 && threadIdx.x == 0) a.n_valid[0] = valid;",
         "    PROF_STAMP\n  }\n  if (blockIdx.x == 0 && threadIdx.x == 0) a.n_valid[0] = valid;",
         1),
        ("  }\n  if (blockIdx.x == 0)\n    for (int b = threadIdx.x; b < B; b += THREADS)"
         " a.n_valid[b] = s_valid[b];",
         "    PROF_STAMP\n  }\n  if (blockIdx.x == 0)\n"
         "    for (int b = threadIdx.x; b < B; b += THREADS) a.n_valid[b] = s_valid[b];", 1),
    ]


def profiled_source() -> str:
    src = (_build.CSRC / "taco_decode.cu").read_text()
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
    cu, so = out / "taco_decode_prof.cu", out / "libtaco_decode_prof.so"
    cu.write_text(profiled_source())
    cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-Xptxas", "-v",
           "-I", str(_build.CSRC), "-o", str(so), str(cu)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(res.stdout + res.stderr)
    return ctypes.CDLL(str(so))


def inputs(tts, seqs, dev):
    """(enc, encp, mask) as the serving path makes them (pad positions
    zeroed), the encoder's BiGRU as a plain step loop."""
    ids, lens = taco.pad_ids(seqs, dev)
    with torch.no_grad():
        enc = tts.encoder(ids, engine="scan", lens=lens)
        mask = (torch.arange(ids.shape[1], device=dev)[None]
                < lens[:, None]).float()
        enc = enc * mask[..., None]
        encp = L.linear(enc, tts.encoder_proj.weight) * mask[..., None]
    return enc, encp, mask


def cases(cfg, tts, dev):
    """(name, kernel, args) at the shapes of the serving paths."""
    cl = cfg.tts.cleaner_names
    sents = [text_to_sequence(s, cl) for s in cs.SENTENCES[:5]]
    g = torch.Generator().manual_seed(7)
    long = [torch.randint(1, 148, (int(n),), generator=g).tolist()
            for n in torch.randint(100, 151, (32,), generator=g)]
    long[0] = long[0] + [5] * (150 - len(long[0]))
    dec = tts.decoder_weights()
    tail = (2, 400, 80, cfg.tts.max_r, -1e30)
    out = []
    enc, encp, _ = inputs(tts, sents[:1], dev)
    out.append(("B2_B1", "decode", (dec, enc, encp,
                                    torch.ones(enc.shape[1], device=dev))
                + tail))
    for name, seqs in (("B8_B1", sents[:1]), ("B8_B5", sents),
                       ("B8_B32", [sents[i % 5] for i in range(32)]),
                       ("B8_B32_T150", long)):
        enc, encp, mask = inputs(tts, seqs, dev)
        out.append((name, "decode_batch", (dec, enc, encp, mask) + tail))
    return out


def main():
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    print(cs.smi_line(), flush=True)
    cfg = Config()
    tts = taco.Tacotron(cfg.tts, 80)
    tts.reset_parameters(torch.Generator().manual_seed(1234))
    tts = tts.to(dev).eval()
    runs = cases(cfg, tts, dev)
    res = {}
    with torch.no_grad():
        for name, fn, args in runs:   # the original body as built
            f = getattr(ctd, fn)
            clk = [cs.gpu_clocks()]
            ms, _ = cs.cuda_ms(lambda: f(*args, _legacy=True), 3)
            clk.append(cs.gpu_clocks())
            res[name] = {"B": args[1].shape[0], "T_text": args[1].shape[1],
                         "original_ms": ms, "clocks": clk}
        lib = build()
        lib.wr_prof_read.argtypes = [ctypes.c_void_p]
        _build._libs["taco_decode"] = lib
        host = (ctypes.c_ulonglong * 128)()
        for name, fn, args in runs:
            f = getattr(ctd, fn)
            f(*args, _legacy=True)   # warm-up
            torch.cuda.synchronize()
            lib.wr_prof_reset()
            clk = [cs.gpu_clocks()]
            ms, _ = cs.cuda_ms(lambda: f(*args, _legacy=True), 1)
            clk.append(cs.gpu_clocks())
            lib.wr_prof_read(host)
            G = 200 * 2   # the warm-up inside cuda_ms and the timed call
            split = {}
            for w, who in ((0, "block0"), (1, "last_block")):
                split[who] = {lab: round(host[w * 64 + i] / G, 1)
                              for i, lab in enumerate(LABELS)}
                split[who]["total"] = round(sum(split[who].values()), 1)
            res[name].update(profiled_ms=ms, profiled_clocks=clk,
                             cycles_per_group=split)
            print(json.dumps({name: res[name]}), flush=True)


if __name__ == "__main__":
    main()
