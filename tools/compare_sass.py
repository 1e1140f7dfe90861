"""Compare the machine code (SASS) of a kernel source's entries between two
checkouts, on a machine with the CUDA toolkit.

Each checkout's ``wavernn_tpu_torch/csrc/<source>.cu`` is compiled to a
cubin for sm_90a with the port's nvcc flags, disassembled with cuobjdump,
and every entry whose name holds ``key`` is compared instruction for
instruction (addresses and encodings dropped; the entries are matched by
the part of their mangled name after ``key``, since the anonymous
namespace's hash follows the file's path). Prints one line per entry:
instructions, and whether the two are identical. Exits 1 when one differs.

    python3 tools/compare_sass.py PARENT_CHECKOUT taco_train_resident taco_af_res
"""
import re
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from wavernn_tpu_torch.ops import _build  # noqa: E402

HERE = Path(__file__).resolve().parents[1]


def sass(root: Path, source: str, out: Path) -> str:
    cubin = out.with_suffix(".cubin")
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-shared", "-Xcompiler",
                                                      "-fPIC")]
    subprocess.run([_build.nvcc_path(), *flags, "-w", "-cubin", "-o",
                    str(cubin),
                    str(root / "wavernn_tpu_torch" / "csrc" / f"{source}.cu")],
                   check=True)
    objdump = Path(_build.nvcc_path()).with_name("cuobjdump")
    return subprocess.run([str(objdump), "-sass", str(cubin)], check=True,
                          capture_output=True, text=True).stdout


def functions(text: str, key: str):
    out, cur = {}, None
    for ln in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", ln)
        if m:
            cur = m.group(1).split(key, 1)[1] if key in m.group(1) else None
            if cur:
                out[cur] = []
            continue
        if cur:
            ins = re.sub(r"/\*[0-9a-f]+\*/", "", ln).strip()
            if ins:
                out[cur].append(ins)
    return out


def main():
    parent, source, key = Path(sys.argv[1]).resolve(), sys.argv[2], sys.argv[3]
    with tempfile.TemporaryDirectory() as tmp:
        with ThreadPoolExecutor(2) as ex:
            old, new = ex.map(lambda r: sass(r[0], source, Path(tmp) / r[1]),
                              ((parent, "parent"), (HERE, "this")))
    old, new = functions(old, key), functions(new, key)
    same = True
    for name in sorted(set(old) | set(new)):
        eq = old.get(name) == new.get(name)
        same &= eq
        print(f"{key}{name[:60]}: {len(old.get(name, []))} / "
              f"{len(new.get(name, []))} instructions, "
              f"{'identical' if eq else 'DIFFERENT'}", flush=True)
    sys.exit(0 if same and old else 1)


if __name__ == "__main__":
    main()
