"""Hold the float32 B6/B7 resident kernels of this checkout to another
checkout's (a parent commit), bit for bit, on a machine with a CUDA card.

Each checkout runs in its own process, builds its own
``taco_tf_resident`` and ``taco_train_resident`` libraries and runs, on
chip_smoke's seeded full-width inputs, B6 at ``B6_FULL`` and at
``B6_TEACHER`` and B7 at ``B7_FULL``: the forward with its streams, then
the backward on random cotangents. It prints a sha256 of every output,
stream and gradient; this script prints, per case, the names of the
tensors whose bytes differ (none: the same results). Exits 1 when any
differs.

    python3 tools/compare_taco_outputs.py PARENT_CHECKOUT
"""
import hashlib
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def digests(base: Path) -> dict:
    sys.path.insert(0, str(base))
    import torch
    import chip_smoke as cs
    from wavernn_tpu_torch.ops import _build
    from wavernn_tpu_torch.ops import cuda_taco_train as ct
    jobs = {n: _build._start(n)
            for n in ("taco_tf_resident", "taco_train_resident")}
    for n, job in jobs.items():
        if job:
            _build._finish(n, job)
    dev = torch.device("cuda")
    out = {}
    for kind, shape in (("b6", cs.B6_FULL), ("b7", cs.B7_FULL),
                        ("b6_teacher", cs.B6_TEACHER)):
        case = cs.b7_case if kind == "b7" else cs.b6_case
        ins, w = case(*shape, dev, 5, kind != "b6_teacher")
        fwd = ct.decoder_af_fwd if kind == "b7" else ct.decoder_tf_fwd
        bwd = ct.decoder_af_bwd if kind == "b7" else ct.decoder_tf_bwd
        mel, sc, st = fwd(*ins, w, save=True)
        g = torch.Generator().manual_seed(6)
        dmel = torch.randn(mel.shape, generator=g).to(dev)
        dsc = torch.randn(sc.shape, generator=g).to(dev)
        grads = bwd(dmel, dsc, st, sc, *ins, w)
        torch.cuda.synchronize()
        ts = {"mel": mel, "scores": sc,
              **{f"s_{k}": v for k, v in st.items()},
              **{f"grad{i}": t for i, t in enumerate(grads)}}
        out[kind] = {k: hashlib.sha256(v.detach().contiguous().cpu().numpy()
                                       .tobytes()).hexdigest()
                     for k, v in ts.items()}
    return out


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--digests":
        print("DIGESTS " + json.dumps(digests(Path(sys.argv[2]))),
              flush=True)
        return 0
    parent = Path(sys.argv[1]).resolve()
    res = {}
    for tag, base in (("parent", parent), ("this", HERE)):
        p = subprocess.run([sys.executable, __file__, "--digests", str(base)],
                           capture_output=True, text=True)
        line = [ln for ln in p.stdout.splitlines()
                if ln.startswith("DIGESTS ")]
        if p.returncode or not line:
            print(f"{tag} failed:\n{p.stderr[-3000:]}")
            return 1
        res[tag] = json.loads(line[0][len("DIGESTS "):])
    same = True
    for kind, want in res["parent"].items():
        got = res["this"][kind]
        diff = [k for k in want if want[k] != got.get(k)]
        same &= not diff
        print(json.dumps({"case": kind, "tensors": len(want),
                          "differ": diff}), flush=True)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
