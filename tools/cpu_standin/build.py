"""Build a CUDA source of ``pedestrians_video_2_carla_torch/csrc`` for the
CPU, against the stand-in headers beside this file (a thread block as
blockDim OS threads, ``mma.sync`` and ``ldmatrix`` as per-warp exchanges,
``cp.async`` as a synchronous copy, a cluster's blocks as threads over each
other's shared memory), into a shared library that ``ctypes`` loads: a way to
run a kernel's logic without a card. It shows wrong indices, races that a
barrier should order and wrong results; not compile errors of ``nvcc``,
timing, or a missing ``cp.async`` wait.

    python tools/cpu_standin/build.py fused_graph_gru.cu OUT_DIR \\
        [--smem-limit BYTES]

``--smem-limit`` replaces the source's ``kMaxSmemBytes`` (where it has
one), so that small shapes take the launch plans of large ones. Writes
``OUT_DIR/<stem>.so``; the number of SMs the plans see is the
``STANDIN_SMS`` environment variable (default 4).
"""
import argparse
import re
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
CSRC = HERE.parents[1] / "pedestrians_video_2_carla_torch" / "csrc"


def split_top(text):
    """``a, b<c, d>, e`` -> the top-level comma-separated parts."""
    parts, depth, cur = [], 0, ""
    for c in text:
        depth += c in "(<"
        depth -= c in ")>"
        if c == "," and depth == 0:
            parts.append(cur)
            cur = ""
        else:
            cur += c
    return parts + [cur]


def rewrite_launches(text):
    """``kernel<T><<<grid, block, smem, stream>>>(args)`` ->
    ``standin_launch(dim3(grid), dim3(block), smem, stream, kernel<T>,
    args)``."""
    out, i = [], 0
    while True:
        j = text.find("<<<", i)
        if j < 0:
            return "".join(out) + text[i:]
        k, depth = j, 0
        while k > 0:    # back over the kernel's name and template arguments
            c = text[k - 1]
            if c == ">":
                depth += 1
            elif c == "<":
                depth -= 1
            elif depth == 0 and not (c.isalnum() or c in "_:"):
                break
            k -= 1
        e = text.index(">>>", j)
        p, depth = e + 4, 1
        while depth:
            depth += {"(": 1, ")": -1}.get(text[p], 0)
            p += 1
        cfg = [c.strip() for c in split_top(text[j + 3:e])]
        cfg += ["0", "nullptr"][len(cfg) - 2:]
        args = text[e + 4:p - 1].strip()
        out += [text[i:k], f"standin_launch(dim3({cfg[0]}), dim3({cfg[1]}), "
                f"{cfg[2]}, {cfg[3]}, {text[k:j]}{', ' + args if args else ''})"]
        i = p


def prepare(text, smem_limit=None):
    text = re.sub(r"extern __shared__ __align__\(16\) float (\w+)\[\];",
                  r"float* \1 = standin_smem();", text)
    text = re.sub(
        r"extern __shared__ __align__\(16\) unsigned char (\w+)\[\];",
        r"unsigned char* \1 = reinterpret_cast<unsigned char*>("
        r"standin_smem());", text)
    if smem_limit is not None:
        text = re.sub(r"(constexpr int kMaxSmemBytes = )\d+;",
                      rf"\g<1>{smem_limit};", text)
    return rewrite_launches(text)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("source")
    parser.add_argument("out_dir")
    parser.add_argument("--smem-limit", type=int, default=None)
    args = parser.parse_args()
    out = Path(args.out_dir)
    out.mkdir(parents=True, exist_ok=True)
    for header in CSRC.glob("*.cuh"):  # the stand-in's own where it has one
        own = HERE / header.name
        (out / header.name).write_text(
            own.read_text() if own.exists() else prepare(header.read_text()))
    name = Path(args.source).name
    src = out / name
    src.write_text(prepare((CSRC / name).read_text(), args.smem_limit))
    so = out / (src.stem + ".so")
    proc = subprocess.run(
        ["g++", "-x", "c++", "-std=c++20", "-O2", "-pthread", "-shared",
         "-fPIC", "-I", str(HERE), "-o", str(so), str(src)],
        capture_output=True, text=True)
    sys.stderr.write(proc.stderr[-20000:])
    if proc.returncode == 0:
        print(so)
    return proc.returncode


if __name__ == "__main__":
    sys.exit(main())
